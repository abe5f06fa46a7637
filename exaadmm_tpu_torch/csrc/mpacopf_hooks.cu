// The multi-period ACOPF inner iteration's hooks: the ramp batch's pack and
// the generator and ramp unpack around the ramp TRON/ALM kernel, the bus
// consensus of all periods (around the bus scatter), z, l, lz and the
// residual.
//
// Replaces: no TPU kernel. These are the counterparts of the fusions that
// XLA compiles from the JAX hooks in exaadmm_tpu/models/mpacopf/model.py:
// _ramp_alm_update's inputs (:162-244), update_x's qg, pg of period 1 and
// ramp unpack (:246-323), update_xbar vmapped over the periods with the
// ramp blend (:326-356), update_z / update_l / update_lz with the ramp
// block (:359-390) and update_residual (:393-438). The ramp TRON/ALM kernel
// (tron_alm_ramp.cu) reads what the pack writes, and the bus sums stay on
// bus_scatter.cu, which these kernels feed and read; both are unchanged.
//
// Layouts: T periods, ngen generators, nline (padded, or a rank's window)
// lines, nbus buses. The state's blocks are (T, ngen, 2), (T, nline, 8)
// and the ramp's (T, ngen), row 0 of the ramp inert. The ramp batch has
// B = (T - 1) ngen lanes, period-major (lane (t - 1) ngen + g). The bus
// sums run on the periods folded into the channels: the arc rows
// (2 nline, T * 8) and generator rows (ngen, T * 4) that bus_scatter sums
// column by column, so each period's sums are those of a single-period
// call, bit for bit.
//
// What bounds them on the H100: bytes, near the launch floor. At synthetic
// 2869 buses x 8 periods (4,877 lines, 430 generators, fp64) one ADMM
// vector is 319,008 values (2.55 MB): z reads five and writes one, 15.3 MB
// (4.6 us at 3.35 TB/s); the residual's first pass moves about as much;
// the bus values 15 MB; l and lz 7.7 MB; the ramp pack and unpack under
// 0.5 MB. Each is one thread per element, lane or row, so one launch
// stands for the 10-60 torch kernels of its plain version.
//
// Rounding: every elementwise result is bit-identical to the plain PyTorch
// version (exaadmm_tpu_torch/models/mpacopf/model.py, ramp.py) run on the
// card. Each expression is written in the plain version's order, with
// --fmad=false and IEEE division and square root (nvcc's defaults). Where
// the plain version divides a tensor by a Python float, PyTorch's CUDA
// kernel multiplies by the reciprocal computed on the host in the tensor's
// type; the wrapper passes that reciprocal here. A clamp is PyTorch's own
// on CUDA: a NaN value, then a NaN bound, passes through, else
// fmin(fmax(v, lo), hi). The ramp block's mask multiplies (0 on row 0, 1
// after), as the plain version's (T, 1) mask does, so 0 * NaN stays NaN;
// the last period's blend adds zeros, as the plain version's zero rows do
// (x + 0.0 turns -0.0 into +0.0). A scalar that a fused driver's graph
// changes between replays (beta, inner_iter) is read through a pointer; a
// host value comes by value.
//
// Reductions (the residual): no atomics. Pass (a), a grid of blocks per
// period (blockIdx.y the period), writes each block's 13 sums (4 masked
// line rows, 4 generator rows, 4 ramp rows, the objective) by a fixed
// tree: a warp's shuffle-down tree, then the warps in order. Pass (b), one
// block, adds each (row, period)'s block sums in a fixed order (lane l
// takes blocks l, l + 32, ...; then a shuffle-down tree), then per period
// the square roots of (generator + line) + ramp, their maximum over the
// periods and the objective's sum over the periods in order. So the result
// is bit-identical from run to run; it differs from torch.sum's order by
// rounding only.
//
// C interface (no PyTorch headers): pointers and the stream as void*, every
// entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLineSums = 4;
constexpr int kSums = 13;   // 4 line, 4 generator, 4 ramp rows, objective
constexpr int kFinalThreads = 1024;

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

// torch.amax's maximum: a NaN wins
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

// a scalar given as a 0-d tensor (pointer) or a host float (value)
template <typename T>
__device__ __forceinline__ T scalar(const T* p, double v) {
  return p != nullptr ? *p : static_cast<T>(v);
}

// the state's ADMM blocks of one quantity: (T, ngen, 2) and (T, nline, 8)
template <typename T>
struct In {
  const T* gen;
  const T* line;
};

template <typename T>
struct Out {
  T* gen;
  T* line;
};

// the ramp block of one quantity: (T, ngen), row 0 inert
template <typename T>
struct Ramp {
  const T* u;
  const T* z;
  const T* l;
  const T* rho;
};

// the pg row's consensus numerator and denominator of (period t,
// generator g) with period t + 1's ramp terms blended in; zeros after the
// last period, added all the same (mpacopf_bus_kernel_cpu.jl:56-64):
// (l + rho (u + z) + r_l + r_rho (r_u + r_z)) / (rho + r_rho)
template <typename T>
__device__ __forceinline__ void gen_p(In<T> u, In<T> z, In<T> l, In<T> rho,
                                      Ramp<T> r, int t, int g, int nper,
                                      int ngen, T* num, T* den) {
  const int p = 2 * (t * ngen + g);
  const bool next = t + 1 < nper;
  const int n = (t + 1) * ngen + g;
  const T rl = next ? r.l[n] : T(0);
  const T rr = next ? r.rho[n] : T(0);
  const T ru = next ? r.u[n] : T(0);
  const T rz = next ? r.z[n] : T(0);
  const T a = l.gen[p] + rho.gen[p] * (u.gen[p] + z.gen[p]);
  *num = (a + rl) + rr * (ru + rz);
  *den = rho.gen[p] + rr;
}

// ---- the ramp batch's pack: one thread per lane i = (t - 1) ngen + g
// writes x0, xl, xu (3, B), the (9, B) parameter block in ramp.PARAM_KEYS
// order (c2, c1, lam_p, rho_p, t_p, lam_h, rho_h, t_h, baseMVA), lam0
// (1, B), mu0 (B,) (10 on the first inner iteration, else the state's
// alm_xi) and the flag (every lane runs)

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ramp_pack_kernel(const T* ug, const T* vg, const T* zg, const T* lg,
                     const T* rg, const T* ru, const T* rs, const T* rl,
                     const T* rrho, const T* rz, const T* rmu, const T* rxi,
                     const T* c2, const T* c1, const T* pgmin,
                     const T* pgmax, const T* ramp_rate, T* x0, T* xl, T* xu,
                     T* P, T* lam0, T* mu0, uint8_t* act, int B, int ngen,
                     const long long* it_p, long long it_v, double obj_scale,
                     double base) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int g = i % ngen;
  const int k = i + ngen;          // (t, g), t >= 1, in the (T, ngen) rows
  const int kp = i;                // (t - 1, g)
  const T lo = pgmin[g], hi = pgmax[g], rr = ramp_rate[g];
  const T nrr = -rr;
  x0[i] = clamp_tensor(ug[2 * k], lo, hi);
  x0[B + i] = clamp_tensor(ru[k], lo, hi);
  x0[2 * B + i] = clamp_tensor(rs[k], nrr, rr);
  xl[i] = lo;
  xl[B + i] = lo;
  xl[2 * B + i] = nrr;
  xu[i] = hi;
  xu[B + i] = hi;
  xu[2 * B + i] = rr;
  P[i] = c2[g] * static_cast<T>(obj_scale);
  P[B + i] = c1[g] * static_cast<T>(obj_scale);
  P[2 * B + i] = lg[2 * k];
  P[3 * B + i] = rg[2 * k];
  P[4 * B + i] = vg[2 * k] - zg[2 * k];
  P[5 * B + i] = rl[k];
  P[6 * B + i] = rrho[k];
  P[7 * B + i] = vg[2 * kp] - rz[k];
  P[8 * B + i] = static_cast<T>(base);
  lam0[i] = rmu[k];
  const long long it = it_p != nullptr ? *it_p : it_v;
  mu0[i] = it <= 1 ? T(10) : rxi[k];
  act[i] = 1;
}

// ---- the generator rows and the ramp unpack: one thread per (t, g)
// writes u_gen (T, ngen, 2): qg of every period, pg of period 1 in closed
// form, pg of the later periods from the batch's x[0]; and with T > 1 the
// ramp's u, s, alm_mu (row 0 zero) and alm_xi (row 0 kept) from x[1],
// x[2], lam[0] and mu

template <typename T>
__global__ void __launch_bounds__(kThreads)
    generator_unpack_kernel(const T* vg, const T* zg, const T* lg,
                            const T* rg, const T* pgmin, const T* pgmax,
                            const T* qgmin, const T* qgmax, const T* c2,
                            const T* c1, const T* rxi, const T* x,
                            const T* lam, const T* mu, T* u, T* ru_out,
                            T* rs_out, T* rmu_out, T* rxi_out, int nper,
                            int ngen, double obj_scale, double base,
                            double base2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nper * ngen) return;
  const int g = i % ngen;
  const int p = 2 * i, q = p + 1;
  const T qg = clamp_tensor((-(lg[q] + rg[q] * (-vg[q] + zg[q]))) / rg[q],
                            qgmin[g], qgmax[g]);
  T pg;
  if (i < ngen) {
    const T c2e = c2[g] * static_cast<T>(obj_scale);
    const T c1e = c1[g] * static_cast<T>(obj_scale);
    pg = clamp_tensor(
        (-((c1e * static_cast<T>(base) + lg[p]) + rg[p] * (-vg[p] + zg[p])))
            / ((c2e * T(2)) * static_cast<T>(base2) + rg[p]),
        pgmin[g], pgmax[g]);
    if (nper > 1) {
      ru_out[i] = T(0);
      rs_out[i] = T(0);
      rmu_out[i] = T(0);
      rxi_out[i] = rxi[i];
    }
  } else {
    const int B = (nper - 1) * ngen;
    const int j = i - ngen;
    pg = x[j];
    ru_out[i] = x[B + j];
    rs_out[i] = x[2 * B + j];
    rmu_out[i] = lam[j];
    rxi_out[i] = mu[j];
  }
  u[p] = pg;
  u[q] = qg;
}

// ---- the bus update of all periods, three launches around the two bus
// scatters

// (a) the rows the scatters sum, periods folded into the channels: one
// thread per (arc row r, period t) writes arcs[r, 8 t .. 8 t + 7] (the
// from-side rows of the lines, then the to-side rows), one per (generator
// g, period t) gens[g, 4 t .. 4 t + 3]; the line mask multiplies, as in
// the plain version, so a padded row is 0 * x
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bus_values_kernel(In<T> u, In<T> z, In<T> l, In<T> rho, Ramp<T> r,
                      const T* mask, T* arcs, T* gens, int nper, int nline,
                      int ngen) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const long long narc = 2LL * nline * nper;
  if (i < narc) {
    const int row = static_cast<int>(i / nper);
    const int t = static_cast<int>(i % nper);
    const int s = row >= nline;
    const int k = row - s * nline;
    const long long b = 8LL * (static_cast<long long>(t) * nline + k);
    const T* uL = u.line + b;
    const T* zL = z.line + b;
    const T* lL = l.line + b;
    const T* rL = rho.line + b;
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
  } else if (i < narc + static_cast<long long>(ngen) * nper) {
    const int j = static_cast<int>(i - narc);
    const int g = j / nper;
    const int t = j % nper;
    T num, den;
    gen_p(u, z, l, rho, r, t, g, nper, ngen, &num, &den);
    const int q = 2 * (t * ngen + g) + 1;
    T* o = gens + 4 * static_cast<long long>(j);
    o[0] = num / den;
    o[1] = (u.gen[q] + z.gen[q]) + l.gen[q] / rho.gen[q];
    o[2] = T(1) / den;
    o[3] = T(1) / rho.gen[q];
  }
}

// (b) the per-bus 2x2 solve for the power-balance multipliers, in the
// reference's elimination order: one thread per (bus b, period t) writes
// the row [wi, ti, mu1, mu2] of wtm (T, nbus, 4) from the folded arc sums
// agg (nbus, T * 8), generator sums gsum (nbus, T * 4) and the loads
// Pd, Qd (T, nbus)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bus_solve_kernel(const T* agg, const T* gsum, const T* Pd, const T* Qd,
                     const T* YshR, const T* YshI, T* wtm, int nper,
                     int nbus, double inv_base) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nper * nbus) return;
  const int b = i / nper;
  const int t = i % nper;
  const T* a = agg + 8 * i;
  const T* gs = gsum + 4 * i;
  const int bt = t * nbus + b;
  const T one = T(1);
  const T rs_wi = a[2], rs_ti = a[3];
  // guard isolated buses (no incident line) against 0/0
  const T s_wi = rs_wi > T(0) ? rs_wi : one;
  const T s_ti = rs_ti > T(0) ? rs_ti : one;
  const T common_wi = a[0] / s_wi;
  const T ib = static_cast<T>(inv_base);
  const T yr = YshR[b], yi = YshI[b];
  T rhs1 = gs[0] - Pd[bt] * ib;
  T rhs2 = gs[1] - Qd[bt] * ib;
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
  T* o = wtm + 4 * bt;
  o[0] = common_wi + (yr * mu1 - yi * mu2) / s_wi;
  o[1] = a[1] / s_ti;
  o[2] = mu1;
  o[3] = mu2;
}

// (c) the writeback: one thread per (period, line) and one per (period,
// generator) gather their buses' rows of wtm and write v; the pg row
// blends period t + 1's ramp terms in as (a) does; a padded line points
// at bus 0
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bus_writeback_kernel(In<T> u, In<T> z, In<T> l, In<T> rho, Ramp<T> r,
                         const T* wtm, const long long* fr,
                         const long long* to, const long long* gb, Out<T> v,
                         int nper, int nline, int ngen, int nbus) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const long long nl = static_cast<long long>(nline) * nper;
  if (i < nl) {
    const int t = static_cast<int>(i / nline);
    const int k = static_cast<int>(i % nline);
    const T* w = wtm + 4LL * t * nbus;
    const T* gf = w + 4 * fr[k];
    const T* gt = w + 4 * to[k];
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
  } else if (i < nl + static_cast<long long>(ngen) * nper) {
    const int j = static_cast<int>(i - nl);
    const int t = j / ngen;
    const int g = j % ngen;
    const int p = 2 * j, q = p + 1;
    const T* gg = wtm + 4LL * t * nbus + 4 * gb[g];
    T num, den;
    gen_p(u, z, l, rho, r, t, g, nper, ngen, &num, &den);
    v.gen[p] = (num - gg[2]) / den;
    v.gen[q] = (u.gen[q] + z.gen[q]) + (l.gen[q] - gg[3]) / rho.gen[q];
  }
}

// ---- z, l, lz: one thread per element of the stacked [gen; line; ramp]
// vector: 2 T ngen generator values, 8 T nline line values, T ngen ramp
// values

// which block element i is in, and its index there
struct Elem {
  int kind;   // 0 generator, 1 line, 2 ramp
  long long j;
};

__device__ __forceinline__ Elem elem(long long i, long long ngen2,
                                     long long nline8) {
  if (i < ngen2) return Elem{0, i};
  if (i < ngen2 + nline8) return Elem{1, i - ngen2};
  return Elem{2, i - ngen2 - nline8};
}

// z = (-(lz + l + rho (u - v))) / (beta + rho); the ramp's with
// safe_rho = where(rho > 0, rho, 1) and v the previous period's pg, times
// the row mask
template <typename T>
__global__ void __launch_bounds__(kThreads)
    z_kernel(In<T> u, In<T> v, In<T> l, In<T> rho, In<T> lz, Out<T> z,
             const T* ru, const T* rl, const T* rrho, const T* rlz, T* rz,
             long long ngen2, long long nline8, long long n, int ngen,
             const T* beta_p, double beta_v) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= n) return;
  const T beta = scalar(beta_p, beta_v);
  const Elem e = elem(i, ngen2, nline8);
  if (e.kind == 2) {
    const int t = static_cast<int>(e.j / ngen);
    const T rr = rrho[e.j];
    const T safe = rr > T(0) ? rr : T(1);
    const T vprev = t == 0 ? T(0) : v.gen[2 * (e.j - ngen)];
    const T zr = (-((rlz[e.j] + rl[e.j]) + safe * (ru[e.j] - vprev)))
                 / (beta + safe);
    rz[e.j] = zr * (t == 0 ? T(0) : T(1));
    return;
  }
  const bool g = e.kind == 0;
  const T uu = g ? u.gen[e.j] : u.line[e.j];
  const T vv = g ? v.gen[e.j] : v.line[e.j];
  const T ll = g ? l.gen[e.j] : l.line[e.j];
  const T rr = g ? rho.gen[e.j] : rho.line[e.j];
  const T zz = g ? lz.gen[e.j] : lz.line[e.j];
  const T out = (-((zz + ll) + rr * (uu - vv))) / (beta + rr);
  if (g)
    z.gen[e.j] = out;
  else
    z.line[e.j] = out;
}

// l = -(lz + beta z); the ramp's times the row mask
template <typename T>
__global__ void __launch_bounds__(kThreads)
    l_kernel(In<T> z, In<T> lz, Out<T> l, const T* rz, const T* rlz, T* rl,
             long long ngen2, long long nline8, long long n, int ngen,
             const T* beta_p, double beta_v) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= n) return;
  const T beta = scalar(beta_p, beta_v);
  const Elem e = elem(i, ngen2, nline8);
  if (e.kind == 2) {
    const int t = static_cast<int>(e.j / ngen);
    rl[e.j] = (-(rlz[e.j] + beta * rz[e.j])) * (t == 0 ? T(0) : T(1));
  } else if (e.kind == 0) {
    l.gen[e.j] = -(lz.gen[e.j] + beta * z.gen[e.j]);
  } else {
    l.line[e.j] = -(lz.line[e.j] + beta * z.line[e.j]);
  }
}

// lz = clamp(lz + beta z, lo, hi); the ramp's unmasked
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lz_kernel(In<T> z, In<T> lz, Out<T> out, const T* rz, const T* rlz,
              T* rout, long long ngen2, long long nline8, long long n,
              const T* beta_p, double beta_v, double lo_v, double hi_v) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= n) return;
  const T beta = scalar(beta_p, beta_v);
  const T lo = static_cast<T>(lo_v), hi = static_cast<T>(hi_v);
  const Elem e = elem(i, ngen2, nline8);
  if (e.kind == 2)
    rout[e.j] = clamp_scalar(rlz[e.j] + beta * rz[e.j], lo, hi);
  else if (e.kind == 0)
    out.gen[e.j] = clamp_scalar(lz.gen[e.j] + beta * z.gen[e.j], lo, hi);
  else
    out.line[e.j] = clamp_scalar(lz.line[e.j] + beta * z.line[e.j], lo, hi);
}

// ---- the residual

// (a) per period t (blockIdx.y) over its 2 ngen generator, ngen ramp and
// 8 nline line elements, in that order: rp = u - v + z and rd = z - z_prev
// of the ADMM blocks, and each block's 13 sums into
// part[(row * T + t) * gridDim.x + block]: rows 0-3 the masked line
// squares of rp, rd, z and rp - z; rows 4-7 the same generator squares
// unmasked; rows 8-11 the ramp's rp_r, rd_r, z_r and rp_r - z_r squared,
// each masked by the row mask as the plain version's; row 12 the
// objective's terms c2 (B pg)^2 + c1 (B pg) + c0 with the raw coefficients
template <typename T>
__global__ void __launch_bounds__(kThreads)
    residual_partials_kernel(In<T> u, In<T> v, In<T> z, In<T> zp,
                             const T* ru, const T* rz, const T* rzp,
                             const T* mask, const T* c2, const T* c1,
                             const T* c0, Out<T> rp, Out<T> rd, T* part,
                             int ngen, int nline, double base) {
  const int t = blockIdx.y;
  const int nper = gridDim.y;
  const int ngen2 = 2 * ngen;
  const int n = 3 * ngen + 8 * nline;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  T s[kSums];
#pragma unroll
  for (int r = 0; r < kSums; ++r) s[r] = T(0);
  if (i < ngen2 || i >= 3 * ngen) {
    if (i < n) {
      const bool g = i < ngen2;
      const long long j = g ? static_cast<long long>(t) * ngen2 + i
                            : 8LL * t * nline + (i - 3 * ngen);
      const T uu = g ? u.gen[j] : u.line[j];
      const T vv = g ? v.gen[j] : v.line[j];
      const T zz = g ? z.gen[j] : z.line[j];
      const T zpp = g ? zp.gen[j] : zp.line[j];
      const T rpv = (uu - vv) + zz;
      const T rdv = zz - zpp;
      const T ax = rpv - zz;
      if (g) {
        rp.gen[j] = rpv;
        rd.gen[j] = rdv;
        s[4] = rpv * rpv;
        s[5] = rdv * rdv;
        s[6] = zz * zz;
        s[7] = ax * ax;
        if ((i & 1) == 0) {
          const int gi = i >> 1;
          const T pg = uu * static_cast<T>(base);
          s[12] = (c2[gi] * (pg * pg) + c1[gi] * pg) + c0[gi];
        }
      } else {
        rp.line[j] = rpv;
        rd.line[j] = rdv;
        const T m = mask[(i - 3 * ngen) >> 3];
        s[0] = (rpv * rpv) * m;
        s[1] = (rdv * rdv) * m;
        s[2] = (zz * zz) * m;
        s[3] = (ax * ax) * m;
      }
    }
  } else {
    const int g = i - ngen2;
    const int k = t * ngen + g;
    const T mt = t == 0 ? T(0) : T(1);
    const T vprev = t == 0 ? T(0) : v.gen[2 * (k - ngen)];
    const T zr = rz[k];
    const T rpr = ((ru[k] - vprev) + zr) * mt;
    const T rdr = (zr - rzp[k]) * mt;
    const T zrm = zr * mt;
    const T d = rpr - zrm;
    s[8] = rpr * rpr;
    s[9] = rdr * rdr;
    s[10] = zrm * zrm;
    s[11] = d * d;
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
    part[(static_cast<long long>(threadIdx.x) * nper + t) * gridDim.x
         + blockIdx.x] = x;
  }
}

// (b) one block of 32 warps: warp w adds the block sums of the (row,
// period) pairs w, w + 32, ... (the line rows from line_part, which a mesh
// has all-reduced, the others from rest_part), then thread 0 forms
// [primres, dualres, norm_z, mismatch, objval, auglag]: per period the
// square root of (generator + line) + ramp, the maximum over the periods;
// the objective summed over the periods in order; auglag the objective
template <typename T>
__global__ void __launch_bounds__(kFinalThreads)
    residual_final_kernel(const T* line_part, const T* rest_part, int nper,
                          int nblocks, T* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tot = reinterpret_cast<T*>(smem);   // (kSums, nper)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pairs = kSums * nper;
  for (int pr = warp; pr < pairs; pr += kFinalThreads / 32) {
    const int r = pr / nper, t = pr % nper;
    const T* row = r < kLineSums
                       ? line_part + (static_cast<long long>(r) * nper + t)
                                         * nblocks
                       : rest_part
                             + (static_cast<long long>(r - kLineSums) * nper
                                + t) * nblocks;
    T x = T(0);
    for (int b = lane; b < nblocks; b += 32) x = x + row[b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = x + __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) tot[pr] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T best[4], obj = T(0);
    for (int t = 0; t < nper; ++t) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const T val = vsqrt((tot[(4 + k) * nper + t] + tot[k * nper + t])
                            + tot[(8 + k) * nper + t]);
        best[k] = t == 0 ? val : nan_max(best[k], val);
      }
      const T o = tot[12 * nper + t];
      obj = t == 0 ? o : obj + o;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = best[k];
    out[4] = obj;
    out[5] = obj;
  }
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

template <typename T>
const T* c(const void* p) {
  return static_cast<const T*>(p);
}

template <typename T>
T* w(void* p) {
  return static_cast<T*>(p);
}

template <typename T>
In<T> in(const void* gen, const void* line) {
  return In<T>{c<T>(gen), c<T>(line)};
}

template <typename T>
Out<T> out(void* gen, void* line) {
  return Out<T>{w<T>(gen), w<T>(line)};
}

template <typename T>
Ramp<T> ramp(const void* u, const void* z, const void* l, const void* rho) {
  return Ramp<T>{c<T>(u), c<T>(z), c<T>(l), c<T>(rho)};
}

cudaStream_t st(void* stream) { return static_cast<cudaStream_t>(stream); }

template <typename T>
int launch_ramp_pack(const void* ug, const void* vg, const void* zg,
                     const void* lg, const void* rg, const void* ru,
                     const void* rs, const void* rl, const void* rrho,
                     const void* rz, const void* rmu, const void* rxi,
                     const void* c2, const void* c1, const void* pgmin,
                     const void* pgmax, const void* ramp_rate, void* x0,
                     void* xl, void* xu, void* P, void* lam0, void* mu0,
                     void* act, int B, int ngen, const void* it_p,
                     long long it_v, double obj_scale, double base,
                     void* stream) {
  if (B > 0)
    ramp_pack_kernel<T><<<blocks_for(B), kThreads, 0, st(stream)>>>(
        c<T>(ug), c<T>(vg), c<T>(zg), c<T>(lg), c<T>(rg), c<T>(ru), c<T>(rs),
        c<T>(rl), c<T>(rrho), c<T>(rz), c<T>(rmu), c<T>(rxi), c<T>(c2),
        c<T>(c1), c<T>(pgmin), c<T>(pgmax), c<T>(ramp_rate), w<T>(x0),
        w<T>(xl), w<T>(xu), w<T>(P), w<T>(lam0), w<T>(mu0),
        static_cast<uint8_t*>(act), B, ngen,
        static_cast<const long long*>(it_p), it_v, obj_scale, base);
  return last_error();
}

template <typename T>
int launch_generator_unpack(const void* vg, const void* zg, const void* lg,
                            const void* rg, const void* pgmin,
                            const void* pgmax, const void* qgmin,
                            const void* qgmax, const void* c2, const void* c1,
                            const void* rxi, const void* x, const void* lam,
                            const void* mu, void* u, void* ru, void* rs,
                            void* rmu, void* rxi_out, int nper, int ngen,
                            double obj_scale, double base, double base2,
                            void* stream) {
  const long long n = static_cast<long long>(nper) * ngen;
  if (n > 0)
    generator_unpack_kernel<T><<<blocks_for(n), kThreads, 0, st(stream)>>>(
        c<T>(vg), c<T>(zg), c<T>(lg), c<T>(rg), c<T>(pgmin), c<T>(pgmax),
        c<T>(qgmin), c<T>(qgmax), c<T>(c2), c<T>(c1), c<T>(rxi), c<T>(x),
        c<T>(lam), c<T>(mu), w<T>(u), w<T>(ru), w<T>(rs), w<T>(rmu),
        w<T>(rxi_out), nper, ngen, obj_scale, base, base2);
  return last_error();
}

template <typename T>
int launch_bus_values(const void* ug, const void* ul, const void* zg,
                      const void* zl, const void* lg, const void* ll,
                      const void* rg, const void* rl, const void* ru,
                      const void* rz, const void* rlam, const void* rrho,
                      const void* mask, void* arcs, void* gens, int nper,
                      int nline, int ngen, void* stream) {
  const long long n = (2LL * nline + ngen) * nper;
  if (n > 0)
    bus_values_kernel<T><<<blocks_for(n), kThreads, 0, st(stream)>>>(
        in<T>(ug, ul), in<T>(zg, zl), in<T>(lg, ll), in<T>(rg, rl),
        ramp<T>(ru, rz, rlam, rrho), c<T>(mask), w<T>(arcs), w<T>(gens),
        nper, nline, ngen);
  return last_error();
}

template <typename T>
int launch_bus_solve(const void* agg, const void* gsum, const void* Pd,
                     const void* Qd, const void* YshR, const void* YshI,
                     void* wtm, int nper, int nbus, double inv_base,
                     void* stream) {
  const long long n = static_cast<long long>(nper) * nbus;
  if (n > 0)
    bus_solve_kernel<T><<<blocks_for(n), kThreads, 0, st(stream)>>>(
        c<T>(agg), c<T>(gsum), c<T>(Pd), c<T>(Qd), c<T>(YshR), c<T>(YshI),
        w<T>(wtm), nper, nbus, inv_base);
  return last_error();
}

template <typename T>
int launch_bus_writeback(const void* ug, const void* ul, const void* zg,
                         const void* zl, const void* lg, const void* ll,
                         const void* rg, const void* rl, const void* ru,
                         const void* rz, const void* rlam, const void* rrho,
                         const void* wtm, const void* fr, const void* to,
                         const void* gb, void* vg, void* vl, int nper,
                         int nline, int ngen, int nbus, void* stream) {
  const long long n = (static_cast<long long>(nline) + ngen) * nper;
  if (n > 0)
    bus_writeback_kernel<T><<<blocks_for(n), kThreads, 0, st(stream)>>>(
        in<T>(ug, ul), in<T>(zg, zl), in<T>(lg, ll), in<T>(rg, rl),
        ramp<T>(ru, rz, rlam, rrho), c<T>(wtm),
        static_cast<const long long*>(fr), static_cast<const long long*>(to),
        static_cast<const long long*>(gb), out<T>(vg, vl), nper, nline, ngen,
        nbus);
  return last_error();
}

template <typename T>
int launch_z(const void* ug, const void* ul, const void* vg, const void* vl,
             const void* lg, const void* ll, const void* rg, const void* rl,
             const void* lzg, const void* lzl, void* zg, void* zl,
             const void* ru, const void* rlam, const void* rrho,
             const void* rlz, void* rz, int nper, int nline, int ngen,
             const void* beta_p, double beta_v, void* stream) {
  const long long ngen2 = 2LL * nper * ngen, nline8 = 8LL * nper * nline;
  const long long n = ngen2 + nline8 + static_cast<long long>(nper) * ngen;
  if (n > 0)
    z_kernel<T><<<blocks_for(n), kThreads, 0, st(stream)>>>(
        in<T>(ug, ul), in<T>(vg, vl), in<T>(lg, ll), in<T>(rg, rl),
        in<T>(lzg, lzl), out<T>(zg, zl), c<T>(ru), c<T>(rlam), c<T>(rrho),
        c<T>(rlz), w<T>(rz), ngen2, nline8, n, ngen, c<T>(beta_p), beta_v);
  return last_error();
}

template <typename T>
int launch_l(const void* zg, const void* zl, const void* lzg, const void* lzl,
             void* og, void* ol, const void* rz, const void* rlz, void* rl,
             int nper, int nline, int ngen, const void* beta_p,
             double beta_v, void* stream) {
  const long long ngen2 = 2LL * nper * ngen, nline8 = 8LL * nper * nline;
  const long long n = ngen2 + nline8 + static_cast<long long>(nper) * ngen;
  if (n > 0)
    l_kernel<T><<<blocks_for(n), kThreads, 0, st(stream)>>>(
        in<T>(zg, zl), in<T>(lzg, lzl), out<T>(og, ol), c<T>(rz), c<T>(rlz),
        w<T>(rl), ngen2, nline8, n, ngen, c<T>(beta_p), beta_v);
  return last_error();
}

template <typename T>
int launch_lz(const void* zg, const void* zl, const void* lzg,
              const void* lzl, void* og, void* ol, const void* rz,
              const void* rlz, void* rout, int nper, int nline, int ngen,
              const void* beta_p, double beta_v, double lo, double hi,
              void* stream) {
  const long long ngen2 = 2LL * nper * ngen, nline8 = 8LL * nper * nline;
  const long long n = ngen2 + nline8 + static_cast<long long>(nper) * ngen;
  if (n > 0)
    lz_kernel<T><<<blocks_for(n), kThreads, 0, st(stream)>>>(
        in<T>(zg, zl), in<T>(lzg, lzl), out<T>(og, ol), c<T>(rz), c<T>(rlz),
        w<T>(rout), ngen2, nline8, n, c<T>(beta_p), beta_v, lo, hi);
  return last_error();
}

template <typename T>
int launch_residual_partials(
    const void* ug, const void* ul, const void* vg, const void* vl,
    const void* zg, const void* zl, const void* zpg, const void* zpl,
    const void* ru, const void* rz, const void* rzp, const void* mask,
    const void* c2, const void* c1, const void* c0, void* rpg, void* rpl,
    void* rdg, void* rdl, void* part, int nper, int nline, int ngen,
    int nblocks, double base, void* stream) {
  const long long n = 3LL * ngen + 8LL * nline;
  // the caller sized part from the same block count
  if (nblocks != static_cast<int>(blocks_for(n)) || nper > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && nper > 0)
    residual_partials_kernel<T>
        <<<dim3(nblocks, nper), kThreads, 0, st(stream)>>>(
            in<T>(ug, ul), in<T>(vg, vl), in<T>(zg, zl), in<T>(zpg, zpl),
            c<T>(ru), c<T>(rz), c<T>(rzp), c<T>(mask), c<T>(c2), c<T>(c1),
            c<T>(c0), out<T>(rpg, rpl), out<T>(rdg, rdl), w<T>(part), ngen,
            nline, base);
  return last_error();
}

template <typename T>
int launch_residual_final(const void* line_part, const void* rest_part,
                          int nper, int nblocks, void* out_, void* stream) {
  const size_t smem = sizeof(T) * kSums * static_cast<size_t>(nper);
  if (nper < 1 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  residual_final_kernel<T><<<1, kFinalThreads, smem, st(stream)>>>(
      c<T>(line_part), c<T>(rest_part), nper, nblocks, w<T>(out_));
  return last_error();
}

}  // namespace

#define MP_ENTRY(NAME, SUFFIX, T, PARAMS, ARGS) \
  int mp_##NAME##_##SUFFIX PARAMS { return launch_##NAME<T> ARGS; }

#define MP_ENTRIES(NAME, PARAMS, ARGS)      \
  MP_ENTRY(NAME, f64, double, PARAMS, ARGS) \
  MP_ENTRY(NAME, f32, float, PARAMS, ARGS)

extern "C" {

MP_ENTRIES(ramp_pack,
           (const void* ug, const void* vg, const void* zg, const void* lg,
            const void* rg, const void* ru, const void* rs, const void* rl,
            const void* rrho, const void* rz, const void* rmu,
            const void* rxi, const void* c2, const void* c1,
            const void* pgmin, const void* pgmax, const void* ramp_rate,
            void* x0, void* xl, void* xu, void* P, void* lam0, void* mu0,
            void* act, int B, int ngen, const void* it_p, long long it_v,
            double obj_scale, double base, void* stream),
           (ug, vg, zg, lg, rg, ru, rs, rl, rrho, rz, rmu, rxi, c2, c1, pgmin,
            pgmax, ramp_rate, x0, xl, xu, P, lam0, mu0, act, B, ngen, it_p,
            it_v, obj_scale, base, stream))

MP_ENTRIES(generator_unpack,
           (const void* vg, const void* zg, const void* lg, const void* rg,
            const void* pgmin, const void* pgmax, const void* qgmin,
            const void* qgmax, const void* c2, const void* c1,
            const void* rxi, const void* x, const void* lam, const void* mu,
            void* u, void* ru, void* rs, void* rmu, void* rxi_out, int nper,
            int ngen, double obj_scale, double base, double base2,
            void* stream),
           (vg, zg, lg, rg, pgmin, pgmax, qgmin, qgmax, c2, c1, rxi, x, lam,
            mu, u, ru, rs, rmu, rxi_out, nper, ngen, obj_scale, base, base2,
            stream))

MP_ENTRIES(bus_values,
           (const void* ug, const void* ul, const void* zg, const void* zl,
            const void* lg, const void* ll, const void* rg, const void* rl,
            const void* ru, const void* rz, const void* rlam,
            const void* rrho, const void* mask, void* arcs, void* gens,
            int nper, int nline, int ngen, void* stream),
           (ug, ul, zg, zl, lg, ll, rg, rl, ru, rz, rlam, rrho, mask, arcs,
            gens, nper, nline, ngen, stream))

MP_ENTRIES(bus_solve,
           (const void* agg, const void* gsum, const void* Pd, const void* Qd,
            const void* YshR, const void* YshI, void* wtm, int nper,
            int nbus, double inv_base, void* stream),
           (agg, gsum, Pd, Qd, YshR, YshI, wtm, nper, nbus, inv_base, stream))

MP_ENTRIES(bus_writeback,
           (const void* ug, const void* ul, const void* zg, const void* zl,
            const void* lg, const void* ll, const void* rg, const void* rl,
            const void* ru, const void* rz, const void* rlam,
            const void* rrho, const void* wtm, const void* fr,
            const void* to, const void* gb, void* vg, void* vl, int nper,
            int nline, int ngen, int nbus, void* stream),
           (ug, ul, zg, zl, lg, ll, rg, rl, ru, rz, rlam, rrho, wtm, fr, to,
            gb, vg, vl, nper, nline, ngen, nbus, stream))

MP_ENTRIES(z,
           (const void* ug, const void* ul, const void* vg, const void* vl,
            const void* lg, const void* ll, const void* rg, const void* rl,
            const void* lzg, const void* lzl, void* zg, void* zl,
            const void* ru, const void* rlam, const void* rrho,
            const void* rlz, void* rz, int nper, int nline, int ngen,
            const void* beta_p, double beta_v, void* stream),
           (ug, ul, vg, vl, lg, ll, rg, rl, lzg, lzl, zg, zl, ru, rlam, rrho,
            rlz, rz, nper, nline, ngen, beta_p, beta_v, stream))

MP_ENTRIES(l,
           (const void* zg, const void* zl, const void* lzg, const void* lzl,
            void* og, void* ol, const void* rz, const void* rlz, void* rl,
            int nper, int nline, int ngen, const void* beta_p, double beta_v,
            void* stream),
           (zg, zl, lzg, lzl, og, ol, rz, rlz, rl, nper, nline, ngen, beta_p,
            beta_v, stream))

MP_ENTRIES(lz,
           (const void* zg, const void* zl, const void* lzg, const void* lzl,
            void* og, void* ol, const void* rz, const void* rlz, void* rout,
            int nper, int nline, int ngen, const void* beta_p, double beta_v,
            double lo, double hi, void* stream),
           (zg, zl, lzg, lzl, og, ol, rz, rlz, rout, nper, nline, ngen,
            beta_p, beta_v, lo, hi, stream))

MP_ENTRIES(residual_partials,
           (const void* ug, const void* ul, const void* vg, const void* vl,
            const void* zg, const void* zl, const void* zpg, const void* zpl,
            const void* ru, const void* rz, const void* rzp,
            const void* mask, const void* c2, const void* c1, const void* c0,
            void* rpg, void* rpl, void* rdg, void* rdl, void* part, int nper,
            int nline, int ngen, int nblocks, double base, void* stream),
           (ug, ul, vg, vl, zg, zl, zpg, zpl, ru, rz, rzp, mask, c2, c1, c0,
            rpg, rpl, rdg, rdl, part, nper, nline, ngen, nblocks, base,
            stream))

MP_ENTRIES(residual_final,
           (const void* line_part, const void* rest_part, int nper,
            int nblocks, void* out_, void* stream),
           (line_part, rest_part, nper, nblocks, out_, stream))

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
