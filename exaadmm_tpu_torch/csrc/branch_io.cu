// The branch update's work around the TRON/ALM launch: the pack (warm
// start, bounds, parameter block, ALM start) and the unpack (flows, the
// masked writeback, the new ALM state, lane steps, the stats).
//
// Replaces: no TPU kernel. These are the counterparts of the fusions that
// XLA compiles from the JAX branch update around its solver call,
// exaadmm_tpu/models/acopf/branch.py: _branch_params (:255) and
// _warm_start_x0 (:270) with the ALM start (:366-368) and the casts of
// mixed precision (:478), and the flows, the masked writeback and the
// stats after the call (:490-536). The TRON/ALM kernels themselves
// (tron_alm_branch.cu, tron_alm_polar.cu) read what the pack writes and
// are unchanged.
//
// What bounds them on the H100: bytes, and at the shapes of the main path
// the launch. At synthetic 9,241 buses (15,710 lines, fp64) the pack reads
// about 490 B a lane (five state rows of 8, the eight admittances, four
// bound pairs, rate_a, the ALM state, the mask) and writes about 430 (x0,
// xl, xu, the 33-row parameter block, lam0, mu0, the flag): 14.5 MB, 4.3
// us at 3.35 TB/s. The unpack moves about 4.8 MB (1.4 us); the stats'
// final pass a few kB. Each is one thread per lane, so one launch stands
// for the 60-odd torch kernels of the plain version.
//
// Rounding: every output is bit-identical to the plain PyTorch version
// (exaadmm_tpu_torch/models/acopf/branch.py: branch_pack_plain,
// branch_unpack_plain) run on the card. Each expression is written in the
// plain version's order, with --fmad=false and IEEE division and square
// root (nvcc's defaults); cos and sin are the CUDA math library's, which
// PyTorch's kernels call too. A clamp is PyTorch's own on CUDA: a NaN
// value, then a NaN bound, passes through, else fmin(fmax(v, lo), hi).
// Mixed precision (an fp64 state, an fp32 solve): the pack computes every
// value in fp64 and rounds once at the store (__double2float_rn), as the
// plain version's fp64 ops followed by .to(torch.float32); the unpack
// widens the solve's fp32 results to fp64 before the flows.
//
// The stats: the unpack writes each block's sums of alm_iters * mask and
// minor_iters * mask and its maximum of where(active, cviol, 0); one block
// adds the partials and takes the maximum (no atomics), and, given a step
// counter, adds the two sums to it (the solve's TRON steps, an int64 count
// read back with the loop's scalars when tracing is on). The sums are of
// integer values well inside the type's exact range, so any order gives
// torch.sum's bits; the maximum does not depend on order. The averages
// multiply by the reciprocal of nline that the wrapper forms on the host,
// as PyTorch's CUDA division of a tensor by a Python number does.
//
// inner_iter, which a fused driver's graph changes between replays, is
// read through a pointer; the host loop's int comes by value.
//
// C interface (no PyTorch headers): pointers and the stream as void*, every
// entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double vsqrt(double a) { return sqrt(a); }
__device__ __forceinline__ float vsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double vcos(double a) { return cos(a); }
__device__ __forceinline__ float vcos(float a) { return cosf(a); }
__device__ __forceinline__ double vsin(double a) { return sin(a); }
__device__ __forceinline__ float vsin(float a) { return sinf(a); }

// torch.clamp(v, min=lo, max=hi) with tensor bounds, as PyTorch's CUDA
// kernel computes it
template <typename T>
__device__ __forceinline__ T clamp_tensor(T v, T lo, T hi) {
  if (v != v) return v;
  if (lo != lo) return lo;
  if (hi != hi) return hi;
  return vmin(vmax(v, lo), hi);
}

// torch.clamp_min(v, lo) with a scalar bound
template <typename T>
__device__ __forceinline__ T clamp_min_scalar(T v, T lo) {
  if (v != v) return v;
  return vmax(v, lo);
}

// torch.amax's maximum: a NaN wins
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

// a store in the solve's type: a value of the state's type, rounded once
__device__ __forceinline__ void put(double* p, double x) { *p = x; }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(float* p, double x) {
  *p = __double2float_rn(x);
}

// what the pack reads: the state's line rows (B, 8), the ALM state (B,),
// and the grid's line arrays at call time (the admittances (B,) in
// Y_KEYS order, the bound pairs (B, 2), rate_a and the mask (B,))
template <typename S>
struct PackIn {
  const S* u;
  const S* v;
  const S* z;
  const S* l;
  const S* rho;
  const S* lam1;
  const S* lam2;
  const S* mu;
  const S* Y[8];
  const S* fr_vm;
  const S* to_vm;
  const S* fr_va;
  const S* to_va;
  const S* rate_a;
  const S* mask;
};

// what the pack writes, in the solve's type: x0, xl, xu (n, B), the
// parameter block (33, B), lam0 (ncon, B), mu0 (B,), and the flag
template <typename V>
struct PackOut {
  V* x0;
  V* xl;
  V* xu;
  V* P;
  V* lam0;
  V* mu0;
  uint8_t* act;
};

// one thread per lane: the warm start from u and the bounds (n = 6 with
// line limits, the two slacks last; else 4), the parameter block in
// pack_params' row order, the ALM start (lam0 from the state, mu0 10 on
// the first inner iteration, else the state's; without line limits no
// multipliers and mu0 10) and the flag line_mask > 0.5
template <typename S, typename V, bool kLimits>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(PackIn<S> in, PackOut<V> out, int B, const long long* it_p,
                long long it_v, double scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const S* u = in.u + 8 * i;
  const S fvl = in.fr_vm[2 * i], fvh = in.fr_vm[2 * i + 1];
  const S tvl = in.to_vm[2 * i], tvh = in.to_vm[2 * i + 1];
  const S fal = in.fr_va[2 * i], fah = in.fr_va[2 * i + 1];
  const S tal = in.to_va[2 * i], tah = in.to_va[2 * i + 1];
  const S zero = S(0);
  put(out.x0 + i,
      clamp_tensor(vsqrt(clamp_min_scalar(u[4], zero)), fvl, fvh));
  put(out.x0 + B + i,
      clamp_tensor(vsqrt(clamp_min_scalar(u[5], zero)), tvl, tvh));
  put(out.x0 + 2 * B + i, clamp_tensor(u[6], fal, fah));
  put(out.x0 + 3 * B + i, clamp_tensor(u[7], tal, tah));
  put(out.xl + i, fvl);
  put(out.xl + B + i, tvl);
  put(out.xl + 2 * B + i, fal);
  put(out.xl + 3 * B + i, tal);
  put(out.xu + i, fvh);
  put(out.xu + B + i, tvh);
  put(out.xu + 2 * B + i, fah);
  put(out.xu + 3 * B + i, tah);
  if (kLimits) {
    const S nra = -in.rate_a[i];
    put(out.x0 + 4 * B + i, clamp_tensor(-(u[0] * u[0] + u[1] * u[1]), nra,
                                         zero));
    put(out.x0 + 5 * B + i, clamp_tensor(-(u[2] * u[2] + u[3] * u[3]), nra,
                                         zero));
    put(out.xl + 4 * B + i, nra);
    put(out.xl + 5 * B + i, nra);
    put(out.xu + 4 * B + i, zero);
    put(out.xu + 5 * B + i, zero);
    put(out.lam0 + i, in.lam1[i]);
    put(out.lam0 + B + i, in.lam2[i]);
    const long long it = it_p != nullptr ? *it_p : it_v;
    put(out.mu0 + i, it <= 1 ? S(10) : in.mu[i]);
  } else {
    put(out.mu0 + i, S(10));
  }
  const S* vL = in.v + 8 * i;
  const S* zL = in.z + 8 * i;
  const S* lL = in.l + 8 * i;
  const S* rL = in.rho + 8 * i;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    put(out.P + k * B + i, in.Y[k][i]);
    put(out.P + (8 + k) * B + i, lL[k]);
    put(out.P + (16 + k) * B + i, rL[k]);
    put(out.P + (24 + k) * B + i, vL[k] - zL[k]);
  }
  put(out.P + 32 * B + i, static_cast<S>(scale));
  out.act[i] = in.mask[i] > S(0.5) ? 1 : 0;
}

// what the unpack reads: the batch's result in the solve's type (x (n, B),
// lam (ncon, B), mu, cviol (B,), the int32 counts), and in the state's
// type the old line rows (B, 8), the admittances and the mask, with the
// flag the pack wrote
template <typename S, typename V>
struct UnpackIn {
  const V* x;
  const V* lam;
  const V* mu;
  const int* minor;
  const int* alm;
  const V* cviol;
  const S* u_old;
  const S* Y[8];
  const S* mask;
  const uint8_t* act;
};

// what it writes: the new line rows (B, 8), the two multipliers and the
// penalty in the state's type (with line limits: widened under mixed
// precision, or into a caller's buffers; else null), the lane steps, and
// per block the two sums and the maximum (part (3, nblocks))
template <typename S>
struct UnpackOut {
  S* u_new;
  S* lam1_up;
  S* lam2_up;
  S* mu_up;
  int* lane_steps;
  S* part;
};

// one thread per lane: the four flows at x, then [pij, qij, pji, qji,
// vi^2, vj^2, thi, thj] where the lane is active, else its old row
template <typename S, typename V, bool kLimits>
__global__ void __launch_bounds__(kThreads)
    unpack_kernel(UnpackIn<S, V> in, UnpackOut<S> out, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  S sum_alm = S(0), sum_minor = S(0), cv = -INFINITY;
  if (i < B) {
    const bool active = in.act[i] != 0;
    S* o = out.u_new + 8 * i;
    if (active) {
      const S vi = static_cast<S>(in.x[i]);
      const S vj = static_cast<S>(in.x[B + i]);
      const S thi = static_cast<S>(in.x[2 * B + i]);
      const S thj = static_cast<S>(in.x[3 * B + i]);
      const S cos_ij = vcos(thi - thj);
      const S sin_ij = vsin(thi - thj);
      const S vv_cos = vi * vj * cos_ij;
      const S vv_sin = vi * vj * sin_ij;
      const S vi2 = vi * vi;
      const S vj2 = vj * vj;
      const S YffR = in.Y[0][i], YffI = in.Y[1][i], YftR = in.Y[2][i],
              YftI = in.Y[3][i], YttR = in.Y[4][i], YttI = in.Y[5][i],
              YtfR = in.Y[6][i], YtfI = in.Y[7][i];
      o[0] = YffR * vi2 + YftR * vv_cos + YftI * vv_sin;
      o[1] = (-YffI) * vi2 - YftI * vv_cos + YftR * vv_sin;
      o[2] = YttR * vj2 + YtfR * vv_cos - YtfI * vv_sin;
      o[3] = (-YttI) * vj2 - YtfI * vv_cos - YtfR * vv_sin;
      o[4] = vi * vi;
      o[5] = vj * vj;
      o[6] = thi;
      o[7] = thj;
    } else {
      const S* old = in.u_old + 8 * i;
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = old[k];
    }
    if (kLimits && out.lam1_up != nullptr) {
      out.lam1_up[i] = static_cast<S>(in.lam[i]);
      out.lam2_up[i] = static_cast<S>(in.lam[B + i]);
      out.mu_up[i] = static_cast<S>(in.mu[i]);
    }
    const S m = in.mask[i];
    out.lane_steps[i] = (in.minor[i] + in.alm[i]) * static_cast<int>(m);
    sum_alm = static_cast<S>(in.alm[i]) * m;
    sum_minor = static_cast<S>(in.minor[i]) * m;
    cv = active ? static_cast<S>(in.cviol[i]) : S(0);
  }
  // the block's two sums and its maximum
  __shared__ S ws[3][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum_alm = sum_alm + __shfl_down_sync(0xffffffffu, sum_alm, off);
    sum_minor = sum_minor + __shfl_down_sync(0xffffffffu, sum_minor, off);
    cv = nan_max(cv, __shfl_down_sync(0xffffffffu, cv, off));
  }
  if (lane == 0) {
    ws[0][warp] = sum_alm;
    ws[1][warp] = sum_minor;
    ws[2][warp] = cv;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    S a = ws[0][0], b = ws[1][0], c = ws[2][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      a = a + ws[0][w];
      b = b + ws[1][w];
      c = nan_max(c, ws[2][w]);
    }
    out.part[blockIdx.x] = a;
    out.part[gridDim.x + blockIdx.x] = b;
    out.part[2 * gridDim.x + blockIdx.x] = c;
  }
}

// one block: the partials' two sums and maximum into out = [sum of
// alm_iters * mask, sum of minor_iters * mask, max cviol, the two sums
// times 1 / nline]; with a step counter (a fused loop built while tracing
// was on), the two sums are added to it as integers too
template <typename S>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const S* part, int nblocks, double inv_nline, S* out,
                 long long* steps) {
  S a = S(0), b = S(0), c = -INFINITY;
  for (int k = threadIdx.x; k < nblocks; k += kThreads) {
    a = a + part[k];
    b = b + part[nblocks + k];
    c = nan_max(c, part[2 * nblocks + k]);
  }
  __shared__ S ws[3][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = a + __shfl_down_sync(0xffffffffu, a, off);
    b = b + __shfl_down_sync(0xffffffffu, b, off);
    c = nan_max(c, __shfl_down_sync(0xffffffffu, c, off));
  }
  if (lane == 0) {
    ws[0][warp] = a;
    ws[1][warp] = b;
    ws[2][warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = ws[0][0];
    b = ws[1][0];
    c = ws[2][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      a = a + ws[0][w];
      b = b + ws[1][w];
      c = nan_max(c, ws[2][w]);
    }
    const S inv = static_cast<S>(inv_nline);
    out[0] = a;
    out[1] = b;
    out[2] = c;
    out[3] = a * inv;
    out[4] = b * inv;
    // the sums hold integer values, so the conversions are exact; the
    // stream orders the adds of successive launches
    if (steps != nullptr)
      *steps += static_cast<long long>(a) + static_cast<long long>(b);
  }
}

unsigned blocks_for(int n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

cudaStream_t st(void* stream) { return static_cast<cudaStream_t>(stream); }

template <typename T>
const T* cp(const void* p) {
  return static_cast<const T*>(p);
}

template <typename S, typename V, bool kLimits>
int launch_pack(const void* u, const void* v, const void* z, const void* l,
                const void* rho, const void* lam1, const void* lam2,
                const void* mu, const void* const* Y, const void* fr_vm,
                const void* to_vm, const void* fr_va, const void* to_va,
                const void* rate_a, const void* mask, void* x0, void* xl,
                void* xu, void* P, void* lam0, void* mu0, void* act, int B,
                const void* it_p, long long it_v, double scale,
                void* stream) {
  PackIn<S> in{cp<S>(u),    cp<S>(v),     cp<S>(z),      cp<S>(l),
               cp<S>(rho),  cp<S>(lam1),  cp<S>(lam2),   cp<S>(mu),
               {},         cp<S>(fr_vm), cp<S>(to_vm),  cp<S>(fr_va),
               cp<S>(to_va), cp<S>(rate_a), cp<S>(mask)};
  for (int k = 0; k < 8; ++k) in.Y[k] = cp<S>(Y[k]);
  PackOut<V> out{static_cast<V*>(x0),  static_cast<V*>(xl),
                 static_cast<V*>(xu),  static_cast<V*>(P),
                 static_cast<V*>(lam0), static_cast<V*>(mu0),
                 static_cast<uint8_t*>(act)};
  if (B > 0)
    pack_kernel<S, V, kLimits><<<blocks_for(B), kThreads, 0, st(stream)>>>(
        in, out, B, cp<long long>(it_p), it_v, scale);
  return last_error();
}

template <typename S, typename V, bool kLimits>
int launch_unpack(const void* x, const void* lam, const void* mu,
                  const void* minor, const void* alm, const void* cviol,
                  const void* u_old, const void* const* Y, const void* mask,
                  const void* act, void* u_new, void* lam1_up,
                  void* lam2_up, void* mu_up, void* lane_steps, void* part,
                  int B, int nblocks, void* stream) {
  // the caller sized part from the same block count
  if (nblocks != static_cast<int>(blocks_for(B)))
    return static_cast<int>(cudaErrorInvalidValue);
  UnpackIn<S, V> in{cp<V>(x),     cp<V>(lam),   cp<V>(mu), cp<int>(minor),
                    cp<int>(alm), cp<V>(cviol), cp<S>(u_old), {},
                    cp<S>(mask),  cp<uint8_t>(act)};
  for (int k = 0; k < 8; ++k) in.Y[k] = cp<S>(Y[k]);
  UnpackOut<S> out{static_cast<S*>(u_new), static_cast<S*>(lam1_up),
                   static_cast<S*>(lam2_up), static_cast<S*>(mu_up),
                   static_cast<int*>(lane_steps), static_cast<S*>(part)};
  if (B > 0)
    unpack_kernel<S, V, kLimits><<<nblocks, kThreads, 0, st(stream)>>>(
        in, out, B);
  return last_error();
}

template <typename S>
int launch_stats(const void* part, int nblocks, double inv_nline, void* out,
                 void* steps, void* stream) {
  if (nblocks > 0)
    stats_kernel<S><<<1, kThreads, 0, st(stream)>>>(
        cp<S>(part), nblocks, inv_nline, static_cast<S*>(out),
        static_cast<long long*>(steps));
  return last_error();
}

}  // namespace

// the pack's and the unpack's entry points: <kernel>_<instance>_<types>,
// instance linelimit (n = 6, ncon = 2) or polar (n = 4, ncon = 0), types
// f64 (fp64 state and solve), f32, or mixed (fp64 state, fp32 solve)
#define PACK_ENTRY(INST, LIMITS, SFX, S, V)                                   \
  int branch_pack_##INST##_##SFX(                                            \
      const void* u, const void* v, const void* z, const void* l,            \
      const void* rho, const void* lam1, const void* lam2, const void* mu,   \
      const void* Y0, const void* Y1, const void* Y2, const void* Y3,        \
      const void* Y4, const void* Y5, const void* Y6, const void* Y7,        \
      const void* fr_vm, const void* to_vm, const void* fr_va,               \
      const void* to_va, const void* rate_a, const void* mask, void* x0,     \
      void* xl, void* xu, void* P, void* lam0, void* mu0, void* act, int B,  \
      const void* it_p, long long it_v, double scale, void* stream) {        \
    const void* Y[8] = {Y0, Y1, Y2, Y3, Y4, Y5, Y6, Y7};                     \
    return launch_pack<S, V, LIMITS>(u, v, z, l, rho, lam1, lam2, mu, Y,     \
                                     fr_vm, to_vm, fr_va, to_va, rate_a,     \
                                     mask, x0, xl, xu, P, lam0, mu0, act, B, \
                                     it_p, it_v, scale, stream);             \
  }

#define UNPACK_ENTRY(INST, LIMITS, SFX, S, V)                                 \
  int branch_unpack_##INST##_##SFX(                                          \
      const void* x, const void* lam, const void* mu, const void* minor,     \
      const void* alm, const void* cviol, const void* u_old, const void* Y0, \
      const void* Y1, const void* Y2, const void* Y3, const void* Y4,        \
      const void* Y5, const void* Y6, const void* Y7, const void* mask,      \
      const void* act, void* u_new, void* lam1_up, void* lam2_up,            \
      void* mu_up, void* lane_steps, void* part, int B, int nblocks,         \
      void* stream) {                                                        \
    const void* Y[8] = {Y0, Y1, Y2, Y3, Y4, Y5, Y6, Y7};                     \
    return launch_unpack<S, V, LIMITS>(x, lam, mu, minor, alm, cviol, u_old, \
                                       Y, mask, act, u_new, lam1_up,         \
                                       lam2_up, mu_up, lane_steps, part, B,  \
                                       nblocks, stream);                     \
  }

#define BRANCH_IO_ENTRIES(INST, LIMITS)             \
  PACK_ENTRY(INST, LIMITS, f64, double, double)     \
  PACK_ENTRY(INST, LIMITS, f32, float, float)       \
  PACK_ENTRY(INST, LIMITS, mixed, double, float)    \
  UNPACK_ENTRY(INST, LIMITS, f64, double, double)   \
  UNPACK_ENTRY(INST, LIMITS, f32, float, float)     \
  UNPACK_ENTRY(INST, LIMITS, mixed, double, float)

extern "C" {

BRANCH_IO_ENTRIES(linelimit, true)
BRANCH_IO_ENTRIES(polar, false)

// steps: an int64 counter that the two sums are added to, or null
int branch_stats_f64(const void* part, int nblocks, double inv_nline,
                     void* out, void* steps, void* stream) {
  return launch_stats<double>(part, nblocks, inv_nline, out, steps, stream);
}

int branch_stats_f32(const void* part, int nblocks, double inv_nline,
                     void* out, void* steps, void* stream) {
  return launch_stats<float>(part, nblocks, inv_nline, out, steps, stream);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
