// The single-period ACOPF inner iteration's closed-form hooks: generator,
// bus consensus (around the bus scatter), z, l, lz and the residual.
//
// Replaces: no TPU kernel. These are the counterparts of the fusions that
// XLA compiles from the JAX hooks in exaadmm_tpu/models/acopf/kernels.py:
// generator_update (:27), bus_update (:221), z_update (:395), l_update
// (:403), lz_update (:408), compute_objval (:416) and residual_update
// (:426). The reference writes each hook as one CUDA kernel
// (acopf_generator_kernel_gpu.jl, acopf_bus_kernel_gpu.jl,
// acopf_admm_update_{z,l,lz,residual}_gpu.jl). The bus update's sums stay
// on csrc/bus_scatter.cu, which these kernels feed and read.
//
// What bounds them on the H100: bytes by count, the launch in fact. At
// 9,241 buses (15,710 lines, 1,386 generators, fp64) one ADMM vector is
// 1.03 MB: z moves about 6.2 MB (1.8 us at 3.35 TB/s), the residual's
// first pass 9.3 MB, the arc values 6 MB, the bus solve 1.5 MB; each does a
// few operations per byte. Every one of them is a few microseconds, near
// a kernel's launch floor, so the design takes one launch per hook where
// the plain version takes 5-60 (a kernel per slice, op, stack and cat).
//
// Rounding: every elementwise result is bit-identical to the plain
// PyTorch version (exaadmm_tpu_torch/models/acopf/kernels.py) run on the
// card. Each expression is written in the plain version's order, with
// --fmad=false and IEEE division and square root (nvcc's defaults). Where
// the plain version divides a tensor by a Python float, PyTorch's CUDA
// kernel multiplies by the reciprocal computed on the host in the
// tensor's type; the wrapper passes that reciprocal here. A clamp is
// PyTorch's own on CUDA: a NaN value, then a NaN bound, passes through,
// else fmin(fmax(v, lo), hi). A scalar that a fused driver's graph changes
// between replays (beta) is read through a pointer; a host float comes by
// value.
//
// Reductions (the residual): no atomics. Pass (a) writes, per block of
// kThreads elements, the block's 15 sums (7 masked line dot products, 7
// generator dot products, the objective) by a fixed tree: a warp's
// shuffle-down tree, then the warps in order. Pass (b), one block, adds
// each row's block sums in a fixed order (lane l takes blocks l, l + 32,
// ...; then a shuffle-down tree) and forms the six scalars. So the result
// is bit-identical from run to run; it differs from torch.sum's order by
// rounding only.
//
// C interface (no PyTorch headers): pointers and the stream as void*, every
// entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLineSums = 7;
constexpr int kGenSums = 8;   // 7 dot products and the objective
constexpr int kSums = kLineSums + kGenSums;

// one ADMM-space vector: (ngen, 2) generator rows, (nline, 8) line rows
template <typename T>
struct In {
  const T* gen;
  const T* line;
  __device__ __forceinline__ T at(bool g, int j) const {
    return g ? gen[j] : line[j];
  }
};

template <typename T>
struct Out {
  T* gen;
  T* line;
  __device__ __forceinline__ void set(bool g, int j, T x) const {
    if (g)
      gen[j] = x;
    else
      line[j] = x;
  }
};

__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vsqrt(double a) { return sqrt(a); }
__device__ __forceinline__ float vsqrt(float a) { return sqrtf(a); }

// torch.clamp(v, min=lo, max=hi) with tensor bounds, as PyTorch's CUDA
// kernel computes it
template <typename T>
__device__ __forceinline__ T clamp_tensor(T v, T lo, T hi) {
  if (v != v) return v;
  if (lo != lo) return lo;
  if (hi != hi) return hi;
  return vmin(vmax(v, lo), hi);
}

// torch.clamp(v, lo, hi) with scalar bounds
template <typename T>
__device__ __forceinline__ T clamp_scalar(T v, T lo, T hi) {
  if (v != v) return v;
  return vmin(vmax(v, lo), hi);
}

// a scalar given as a 0-d tensor (pointer) or a host float (value)
template <typename T>
__device__ __forceinline__ T scalar(const T* p, double v) {
  return p != nullptr ? *p : static_cast<T>(v);
}

// ---- z, l, lz: one thread per element of the stacked [gen; line] vector

// z = (-(lz + l + rho (u - v))) / (beta + rho)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    z_kernel(In<T> u, In<T> v, In<T> l, In<T> rho, In<T> lz, Out<T> z,
             int ngen2, int n, const T* beta_p, double beta_v) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool g = i < ngen2;
  const int j = g ? i : i - ngen2;
  const T beta = scalar(beta_p, beta_v);
  const T rr = rho.at(g, j);
  z.set(g, j, (-((lz.at(g, j) + l.at(g, j)) + rr * (u.at(g, j) - v.at(g, j))))
                  / (beta + rr));
}

// l = -(lz + beta z)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    l_kernel(In<T> z, In<T> lz, Out<T> l, int ngen2, int n, const T* beta_p,
             double beta_v) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool g = i < ngen2;
  const int j = g ? i : i - ngen2;
  const T beta = scalar(beta_p, beta_v);
  l.set(g, j, -(lz.at(g, j) + beta * z.at(g, j)));
}

// lz = clamp(lz + beta z, lo, hi)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lz_kernel(In<T> z, In<T> lz, Out<T> out, int ngen2, int n,
              const T* beta_p, double beta_v, double lo, double hi) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool g = i < ngen2;
  const int j = g ? i : i - ngen2;
  const T beta = scalar(beta_p, beta_v);
  out.set(g, j, clamp_scalar(lz.at(g, j) + beta * z.at(g, j),
                             static_cast<T>(lo), static_cast<T>(hi)));
}

// ---- the generator update: one thread per generator

template <typename T>
__global__ void __launch_bounds__(kThreads)
    generator_kernel(const T* v, const T* z, const T* l, const T* rho,
                     const T* pgmin, const T* pgmax, const T* qgmin,
                     const T* qgmax, const T* c2, const T* c1, T* u, int ngen,
                     double obj_scale, double base, double base2) {
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= ngen) return;
  const int p = 2 * gi, q = p + 1;
  const T c2e = c2[gi] * static_cast<T>(obj_scale);
  const T c1e = c1[gi] * static_cast<T>(obj_scale);
  const T pg = (-((c1e * static_cast<T>(base) + l[p]) + rho[p] * (-v[p] + z[p])))
               / ((c2e * T(2)) * static_cast<T>(base2) + rho[p]);
  const T qg = (-(l[q] + rho[q] * (-v[q] + z[q]))) / rho[q];
  u[p] = clamp_tensor(pg, pgmin[gi], pgmax[gi]);
  u[q] = clamp_tensor(qg, qgmin[gi], qgmax[gi]);
}

// ---- the bus update, three launches around the two bus scatters

// (a) the rows the scatters sum: one thread per arc row (the from-side rows
// of the lines, then the to-side rows; (2 nline, 8)) and one per generator
// ((ngen, 4)); the line mask multiplies, as in the plain version, so a
// padded row is 0 * x
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bus_values_kernel(In<T> u, In<T> z, In<T> l, In<T> rho, const T* mask,
                      T* arcs, T* gens, int nline, int ngen) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 2 * nline) {
    const int s = i >= nline;
    const int k = i - s * nline;
    const T* uL = u.line + 8 * k;
    const T* zL = z.line + 8 * k;
    const T* lL = l.line + 8 * k;
    const T* rL = rho.line + 8 * k;
    const T m = mask[k];
    const int cw = 4 + s, ct = 6 + s, ca = 2 * s, cb = 2 * s + 1;
    T* o = arcs + 8 * i;
    o[0] = (lL[cw] + rL[cw] * (uL[cw] + zL[cw])) * m;
    o[1] = (lL[ct] + rL[ct] * (uL[ct] + zL[ct])) * m;
    o[2] = rL[cw] * m;
    o[3] = rL[ct] * m;
    o[4] = m / rL[ca];
    o[5] = m / rL[cb];
    o[6] = ((uL[ca] + zL[ca]) + lL[ca] / rL[ca]) * m;
    o[7] = ((uL[cb] + zL[cb]) + lL[cb] / rL[cb]) * m;
  } else if (i < 2 * nline + ngen) {
    const int gi = i - 2 * nline;
    const int p = 2 * gi, q = p + 1;
    const T num = l.gen[p] + rho.gen[p] * (u.gen[p] + z.gen[p]);
    const T den = rho.gen[p];
    T* o = gens + 4 * gi;
    o[0] = num / den;
    o[1] = (u.gen[q] + z.gen[q]) + l.gen[q] / rho.gen[q];
    o[2] = T(1) / den;
    o[3] = T(1) / rho.gen[q];
  }
}

// (b) the per-bus 2x2 solve for the power-balance multipliers, in the
// reference's elimination order: one thread per bus writes its row
// [wi, ti, mu1, mu2] of wtm (nbus, 4) from its arc sums agg (nbus, 8) and
// generator sums gsum (nbus, 4)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bus_solve_kernel(const T* agg, const T* gsum, const T* Pd, const T* Qd,
                     const T* YshR, const T* YshI, T* wtm, int nbus,
                     double inv_base) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nbus) return;
  const T* a = agg + 8 * b;
  const T* gs = gsum + 4 * b;
  const T one = T(1);
  const T rs_wi = a[2], rs_ti = a[3];
  // guard isolated buses (no incident line) against 0/0
  const T s_wi = rs_wi > T(0) ? rs_wi : one;
  const T s_ti = rs_ti > T(0) ? rs_ti : one;
  const T common_wi = a[0] / s_wi;
  const T ib = static_cast<T>(inv_base);
  const T yr = YshR[b], yi = YshI[b];
  T rhs1 = gs[0] - Pd[b] * ib;
  T rhs2 = gs[1] - Qd[b] * ib;
  rhs1 = rhs1 - a[6];
  rhs2 = rhs2 - a[7];
  rhs1 = rhs1 - yr * common_wi;
  rhs2 = rhs2 + yi * common_wi;
  const T A11 = (gs[2] + a[4]) + (yr * yr / s_wi);
  const T A12 = -yr * (yi / s_wi);
  const T A22 = (gs[3] + a[5]) + (yi * yi / s_wi);
  const T sA11 = A11 != T(0) ? A11 : one;
  const T mu2 = (rhs2 - (A12 / sA11) * rhs1) / (A22 - (A12 / sA11) * A12);
  const T mu1 = (rhs1 - A12 * mu2) / sA11;
  T* o = wtm + 4 * b;
  o[0] = common_wi + (yr * mu1 - yi * mu2) / s_wi;
  o[1] = a[1] / s_ti;
  o[2] = mu1;
  o[3] = mu2;
}

// (c) the writeback: one thread per line row and one per generator gather
// their buses' rows of wtm and write v; a padded line points at bus 0
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bus_writeback_kernel(In<T> u, In<T> z, In<T> l, In<T> rho, const T* wtm,
                         const long long* fr, const long long* to,
                         const long long* gb, Out<T> v, int nline,
                         int ngen) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nline) {
    const T* gf = wtm + 4 * fr[i];
    const T* gt = wtm + 4 * to[i];
    const T* uL = u.line + 8 * i;
    const T* zL = z.line + 8 * i;
    const T* lL = l.line + 8 * i;
    const T* rL = rho.line + 8 * i;
    T* o = v.line + 8 * i;
    o[0] = (uL[0] + zL[0]) + (lL[0] + gf[2]) / rL[0];
    o[1] = (uL[1] + zL[1]) + (lL[1] + gf[3]) / rL[1];
    o[2] = (uL[2] + zL[2]) + (lL[2] + gt[2]) / rL[2];
    o[3] = (uL[3] + zL[3]) + (lL[3] + gt[3]) / rL[3];
    o[4] = gf[0];
    o[5] = gt[0];
    o[6] = gf[1];
    o[7] = gt[1];
  } else if (i < nline + ngen) {
    const int gi = i - nline;
    const int p = 2 * gi, q = p + 1;
    const T* gg = wtm + 4 * gb[gi];
    const T num = l.gen[p] + rho.gen[p] * (u.gen[p] + z.gen[p]);
    v.gen[p] = (num - gg[2]) / rho.gen[p];
    v.gen[q] = (u.gen[q] + z.gen[q]) + (l.gen[q] - gg[3]) / rho.gen[q];
  }
}

// ---- the residual

// (a) rp = u - v + z and rd = z - z_prev, one thread per element of the
// stacked [gen; line] vector, and each block's 15 sums into
// part[row * gridDim.x + block]: rows 0-6 the masked line products of
// rp.rp, rd.rd, z.z, (rp - z).(rp - z), lz.z, l.rp, rho.(rp rp); rows 7-13
// the same generator products unmasked; row 14 the objective's terms
// c2 (B pg)^2 + c1 (B pg) + c0 with the raw coefficients
template <typename T>
__global__ void __launch_bounds__(kThreads)
    residual_partials_kernel(In<T> u, In<T> v, In<T> z, In<T> zp, In<T> lz,
                             In<T> l, In<T> rho, const T* mask, const T* c2,
                             const T* c1, const T* c0, Out<T> rp, Out<T> rd,
                             T* part, int ngen2, int n, double base) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  T s[kSums];
#pragma unroll
  for (int r = 0; r < kSums; ++r) s[r] = T(0);
  if (i < n) {
    const bool g = i < ngen2;
    const int j = g ? i : i - ngen2;
    const T uu = u.at(g, j), zz = z.at(g, j);
    const T rpv = (uu - v.at(g, j)) + zz;
    const T rdv = zz - zp.at(g, j);
    const T ax = rpv - zz;
    rp.set(g, j, rpv);
    rd.set(g, j, rdv);
    const T lzz = lz.at(g, j), ll = l.at(g, j), rr = rho.at(g, j);
    if (g) {
      s[7] = rpv * rpv;
      s[8] = rdv * rdv;
      s[9] = zz * zz;
      s[10] = ax * ax;
      s[11] = lzz * zz;
      s[12] = ll * rpv;
      s[13] = rr * (rpv * rpv);
      if ((j & 1) == 0) {
        const int gi = j >> 1;
        const T pg = uu * static_cast<T>(base);
        s[14] = (c2[gi] * (pg * pg) + c1[gi] * pg) + c0[gi];
      }
    } else {
      const T m = mask[j >> 3];
      s[0] = (rpv * rpv) * m;
      s[1] = (rdv * rdv) * m;
      s[2] = (zz * zz) * m;
      s[3] = (ax * ax) * m;
      s[4] = (lzz * zz) * m;
      s[5] = (ll * rpv) * m;
      s[6] = (rr * (rpv * rpv)) * m;
    }
  }
  __shared__ T warp_sums[kSums][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kSums; ++r) {
    T x = s[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = x + __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_sums[r][warp] = x;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    T x = warp_sums[threadIdx.x][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x = x + warp_sums[threadIdx.x][w];
    part[threadIdx.x * gridDim.x + blockIdx.x] = x;
  }
}

// (b) one block of kSums warps: warp r adds row r's nblocks block sums
// (the line rows from line_part, which a mesh has all-reduced, the others
// from gen_part), then thread 0 forms [primres, dualres, norm_z, mismatch,
// objval, auglag] in the plain version's order
template <typename T>
__global__ void __launch_bounds__(kSums * 32)
    residual_final_kernel(const T* line_part, const T* gen_part, int nblocks,
                          const T* beta_p, double beta_v, T* out) {
  __shared__ T tot[kSums];
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  const T* row = r < kLineSums ? line_part + r * nblocks
                               : gen_part + (r - kLineSums) * nblocks;
  T x = T(0);
  for (int b = lane; b < nblocks; b += 32) x = x + row[b];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = x + __shfl_down_sync(0xffffffffu, x, off);
  if (lane == 0) tot[r] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    const T* L = tot;
    const T* G = tot + kLineSums;
    const T beta = scalar(beta_p, beta_v);
    const T z_sq = G[2] + L[2];
    const T objval = G[7];
    out[0] = vsqrt(G[0] + L[0]);
    out[1] = vsqrt(G[1] + L[1]);
    out[2] = vsqrt(z_sq);
    out[3] = vsqrt(G[3] + L[3]);
    out[4] = objval;
    out[5] = (((objval + (G[4] + L[4])) + (T(0.5) * beta) * z_sq)
              + (G[5] + L[5])) + T(0.5) * (G[6] + L[6]);
  }
}

// an empty kernel: its device time is the floor under every launch
__global__ void empty_kernel() {}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

template <typename T>
In<T> in(const void* gen, const void* line) {
  return In<T>{static_cast<const T*>(gen), static_cast<const T*>(line)};
}

template <typename T>
Out<T> out(void* gen, void* line) {
  return Out<T>{static_cast<T*>(gen), static_cast<T*>(line)};
}

cudaStream_t st(void* stream) { return static_cast<cudaStream_t>(stream); }

template <typename T>
int launch_z(const void* ug, const void* ul, const void* vg, const void* vl,
             const void* lg, const void* ll, const void* rg, const void* rl,
             const void* lzg, const void* lzl, void* zg, void* zl, int ngen2,
             int nline8, const void* beta_p, double beta_v, void* stream) {
  const int n = ngen2 + nline8;
  if (n > 0)
    z_kernel<T><<<blocks_for(n), kThreads, 0, st(stream)>>>(
        in<T>(ug, ul), in<T>(vg, vl), in<T>(lg, ll), in<T>(rg, rl),
        in<T>(lzg, lzl), out<T>(zg, zl), ngen2, n,
        static_cast<const T*>(beta_p), beta_v);
  return last_error();
}

template <typename T>
int launch_l(const void* zg, const void* zl, const void* lzg, const void* lzl,
             void* og, void* ol, int ngen2, int nline8, const void* beta_p,
             double beta_v, void* stream) {
  const int n = ngen2 + nline8;
  if (n > 0)
    l_kernel<T><<<blocks_for(n), kThreads, 0, st(stream)>>>(
        in<T>(zg, zl), in<T>(lzg, lzl), out<T>(og, ol), ngen2, n,
        static_cast<const T*>(beta_p), beta_v);
  return last_error();
}

template <typename T>
int launch_lz(const void* zg, const void* zl, const void* lzg,
              const void* lzl, void* og, void* ol, int ngen2, int nline8,
              const void* beta_p, double beta_v, double lo, double hi,
              void* stream) {
  const int n = ngen2 + nline8;
  if (n > 0)
    lz_kernel<T><<<blocks_for(n), kThreads, 0, st(stream)>>>(
        in<T>(zg, zl), in<T>(lzg, lzl), out<T>(og, ol), ngen2, n,
        static_cast<const T*>(beta_p), beta_v, lo, hi);
  return last_error();
}

template <typename T>
int launch_generator(const void* v, const void* z, const void* l,
                     const void* rho, const void* pgmin, const void* pgmax,
                     const void* qgmin, const void* qgmax, const void* c2,
                     const void* c1, void* u, int ngen, double obj_scale,
                     double base, double base2, void* stream) {
  if (ngen > 0)
    generator_kernel<T><<<blocks_for(ngen), kThreads, 0, st(stream)>>>(
        static_cast<const T*>(v), static_cast<const T*>(z),
        static_cast<const T*>(l), static_cast<const T*>(rho),
        static_cast<const T*>(pgmin), static_cast<const T*>(pgmax),
        static_cast<const T*>(qgmin), static_cast<const T*>(qgmax),
        static_cast<const T*>(c2), static_cast<const T*>(c1),
        static_cast<T*>(u), ngen, obj_scale, base, base2);
  return last_error();
}

template <typename T>
int launch_bus_values(const void* ug, const void* ul, const void* zg,
                      const void* zl, const void* lg, const void* ll,
                      const void* rg, const void* rl, const void* mask,
                      void* arcs, void* gens, int nline, int ngen,
                      void* stream) {
  const long long n = 2LL * nline + ngen;
  if (n > 0)
    bus_values_kernel<T><<<blocks_for(n), kThreads, 0, st(stream)>>>(
        in<T>(ug, ul), in<T>(zg, zl), in<T>(lg, ll), in<T>(rg, rl),
        static_cast<const T*>(mask), static_cast<T*>(arcs),
        static_cast<T*>(gens), nline, ngen);
  return last_error();
}

template <typename T>
int launch_bus_solve(const void* agg, const void* gsum, const void* Pd,
                     const void* Qd, const void* YshR, const void* YshI,
                     void* wtm, int nbus, double inv_base, void* stream) {
  if (nbus > 0)
    bus_solve_kernel<T><<<blocks_for(nbus), kThreads, 0, st(stream)>>>(
        static_cast<const T*>(agg), static_cast<const T*>(gsum),
        static_cast<const T*>(Pd), static_cast<const T*>(Qd),
        static_cast<const T*>(YshR), static_cast<const T*>(YshI),
        static_cast<T*>(wtm), nbus, inv_base);
  return last_error();
}

template <typename T>
int launch_bus_writeback(const void* ug, const void* ul, const void* zg,
                         const void* zl, const void* lg, const void* ll,
                         const void* rg, const void* rl, const void* wtm,
                         const void* fr, const void* to, const void* gb,
                         void* vg, void* vl, int nline, int ngen,
                         void* stream) {
  const long long n = static_cast<long long>(nline) + ngen;
  if (n > 0)
    bus_writeback_kernel<T><<<blocks_for(n), kThreads, 0, st(stream)>>>(
        in<T>(ug, ul), in<T>(zg, zl), in<T>(lg, ll), in<T>(rg, rl),
        static_cast<const T*>(wtm), static_cast<const long long*>(fr),
        static_cast<const long long*>(to), static_cast<const long long*>(gb),
        out<T>(vg, vl), nline, ngen);
  return last_error();
}

template <typename T>
int launch_residual_partials(
    const void* ug, const void* ul, const void* vg, const void* vl,
    const void* zg, const void* zl, const void* zpg, const void* zpl,
    const void* lzg, const void* lzl, const void* lg, const void* ll,
    const void* rg, const void* rl, const void* mask, const void* c2,
    const void* c1, const void* c0, void* rpg, void* rpl, void* rdg,
    void* rdl, void* part, int ngen2, int nline8, int nblocks, double base,
    void* stream) {
  const int n = ngen2 + nline8;
  // the caller sized part from the same block count
  if (nblocks != static_cast<int>(blocks_for(n)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    residual_partials_kernel<T><<<nblocks, kThreads, 0, st(stream)>>>(
        in<T>(ug, ul), in<T>(vg, vl), in<T>(zg, zl), in<T>(zpg, zpl),
        in<T>(lzg, lzl), in<T>(lg, ll), in<T>(rg, rl),
        static_cast<const T*>(mask), static_cast<const T*>(c2),
        static_cast<const T*>(c1), static_cast<const T*>(c0),
        out<T>(rpg, rpl), out<T>(rdg, rdl), static_cast<T*>(part), ngen2, n,
        base);
  return last_error();
}

template <typename T>
int launch_residual_final(const void* line_part, const void* gen_part,
                          int nblocks, const void* beta_p, double beta_v,
                          void* out_, void* stream) {
  residual_final_kernel<T><<<1, kSums * 32, 0, st(stream)>>>(
      static_cast<const T*>(line_part), static_cast<const T*>(gen_part),
      nblocks, static_cast<const T*>(beta_p), beta_v, static_cast<T*>(out_));
  return last_error();
}

}  // namespace

#define ACOPF_ENTRY(NAME, SUFFIX, T, PARAMS, ARGS) \
  int acopf_##NAME##_##SUFFIX PARAMS { return launch_##NAME<T> ARGS; }

#define ACOPF_ENTRIES(NAME, PARAMS, ARGS)         \
  ACOPF_ENTRY(NAME, f64, double, PARAMS, ARGS)    \
  ACOPF_ENTRY(NAME, f32, float, PARAMS, ARGS)

extern "C" {

ACOPF_ENTRIES(z,
              (const void* ug, const void* ul, const void* vg, const void* vl,
               const void* lg, const void* ll, const void* rg, const void* rl,
               const void* lzg, const void* lzl, void* zg, void* zl,
               int ngen2, int nline8, const void* beta_p, double beta_v,
               void* stream),
              (ug, ul, vg, vl, lg, ll, rg, rl, lzg, lzl, zg, zl, ngen2,
               nline8, beta_p, beta_v, stream))

ACOPF_ENTRIES(l,
              (const void* zg, const void* zl, const void* lzg,
               const void* lzl, void* og, void* ol, int ngen2, int nline8,
               const void* beta_p, double beta_v, void* stream),
              (zg, zl, lzg, lzl, og, ol, ngen2, nline8, beta_p, beta_v,
               stream))

ACOPF_ENTRIES(lz,
              (const void* zg, const void* zl, const void* lzg,
               const void* lzl, void* og, void* ol, int ngen2, int nline8,
               const void* beta_p, double beta_v, double lo, double hi,
               void* stream),
              (zg, zl, lzg, lzl, og, ol, ngen2, nline8, beta_p, beta_v, lo,
               hi, stream))

ACOPF_ENTRIES(generator,
              (const void* v, const void* z, const void* l, const void* rho,
               const void* pgmin, const void* pgmax, const void* qgmin,
               const void* qgmax, const void* c2, const void* c1, void* u,
               int ngen, double obj_scale, double base, double base2,
               void* stream),
              (v, z, l, rho, pgmin, pgmax, qgmin, qgmax, c2, c1, u, ngen,
               obj_scale, base, base2, stream))

ACOPF_ENTRIES(bus_values,
              (const void* ug, const void* ul, const void* zg,
               const void* zl, const void* lg, const void* ll,
               const void* rg, const void* rl, const void* mask, void* arcs,
               void* gens, int nline, int ngen, void* stream),
              (ug, ul, zg, zl, lg, ll, rg, rl, mask, arcs, gens, nline, ngen,
               stream))

ACOPF_ENTRIES(bus_solve,
              (const void* agg, const void* gsum, const void* Pd,
               const void* Qd, const void* YshR, const void* YshI, void* wtm,
               int nbus, double inv_base, void* stream),
              (agg, gsum, Pd, Qd, YshR, YshI, wtm, nbus, inv_base, stream))

ACOPF_ENTRIES(bus_writeback,
              (const void* ug, const void* ul, const void* zg,
               const void* zl, const void* lg, const void* ll,
               const void* rg, const void* rl, const void* wtm,
               const void* fr, const void* to, const void* gb, void* vg,
               void* vl, int nline, int ngen, void* stream),
              (ug, ul, zg, zl, lg, ll, rg, rl, wtm, fr, to, gb, vg, vl,
               nline, ngen, stream))

ACOPF_ENTRIES(residual_partials,
              (const void* ug, const void* ul, const void* vg,
               const void* vl, const void* zg, const void* zl,
               const void* zpg, const void* zpl, const void* lzg,
               const void* lzl, const void* lg, const void* ll,
               const void* rg, const void* rl, const void* mask,
               const void* c2, const void* c1, const void* c0, void* rpg,
               void* rpl, void* rdg, void* rdl, void* part, int ngen2,
               int nline8, int nblocks, double base, void* stream),
              (ug, ul, vg, vl, zg, zl, zpg, zpl, lzg, lzl, lg, ll, rg, rl,
               mask, c2, c1, c0, rpg, rpl, rdg, rdl, part, ngen2, nline8,
               nblocks, base, stream))

ACOPF_ENTRIES(residual_final,
              (const void* line_part, const void* gen_part, int nblocks,
               const void* beta_p, double beta_v, void* out_, void* stream),
              (line_part, gen_part, nblocks, beta_p, beta_v, out_, stream))

int acopf_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, st(stream)>>>();
  return last_error();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
