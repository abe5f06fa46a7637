// TRON/ALM batch body, shared by every problem instance: one small
// bound-constrained subproblem per group of kGroup threads.
//
// Replaces: exaadmm_tpu/ops/tron_pallas.py::tron_alm_batched_pallas, whose
// body is exaadmm_tpu/ops/tron.py::tron_alm_batched. The plain version it is
// checked against is exaadmm_tpu_torch/ops/tron.py::tron_alm_batched.
//
// What bounds it on the H100: the dependent chain of its slowest warp, not
// bytes and not FLOP/s. A lane reads a few dozen values and writes a few
// (8 MB for 15,710 lines, 2.4 us at 3.35 TB/s), and all lanes together do
// some 10^8 fp64 operations (a few us at 34 TFLOP/s). But the launch is one
// wave, and between its reads and writes a lane runs up to a few dozen
// trust-region steps, each one fixed chain of dependent scalar work: the
// gradient and Hessian, the Cauchy search (a square root and a
// matrix-vector product per trial), a 6x6 Cholesky factorization (six
// square roots and six divisions in a row), two triangular solves, the
// projected search and the objective (a sin and a cos). A warp also runs,
// in turn, every path its lanes take in an iteration (another lane's extra
// Cauchy trials, its ALM round), and the kernel ends when the slowest warp
// ends.
//
// Design: the G = kGroup threads of a group (consecutive lanes of one warp)
// share one lane.
//   - Control and vectors are replicated: every thread of the group holds x,
//     g, the step vectors and the scalars, and takes every decision itself,
//     on identical values, so the group never diverges and a decision costs
//     no communication. A group whose lane has finished exits; nothing waits
//     for it (no __syncthreads; each shuffle names only its group's threads).
//   - The symmetric Hessian, its masked copy and the Cholesky factor are
//     spread by rows: thread r of the group keeps rows r, r + G, ... (its
//     "slots"), in full. The matrix-vector products, the masking and the
//     row updates of each Cholesky column run on the group's threads at
//     once, and their results reach every thread by __shfl_sync.
//   - What the group shares and only reads (the problem's parameters and
//     the bounds xl, xu) lives once per lane in shared memory, loaded once.
// So a thread holds a fraction of the lane's matrices and none of its
// parameters, which keeps the fp64 builds out of local memory.
//   - The chain is cut where the plain version's arithmetic allows: both
//     Cauchy tests are always taken (their chains overlap), the objective at
//     the first projected-search trial (taken on nearly every step) is
//     evaluated beside its test, the ALM round calls pow once, and the
//     branch problem reuses sin and cos of an angle it has just seen.
// What the measurements showed (PERF.md): splitting a lane shortens little
// of its chain, since the chain is serial and the replicated work costs G
// times the issue slots; the shuffles lengthen it. G = 2 is the fastest of
// 2, 4 and 8 on the branch and QP batches and the only one with no local
// memory in fp64.
//
// Exactness: every sum keeps the plain version's order. A distributed sum
// is gathered term by term with __shfl_sync and added in row order, so each
// lane's arithmetic is the plain version's, operation for operation; the
// libraries are compiled with --fmad=false (no fused multiply-adds). Every
// lane's trajectory in tron.py is independent of the others (every lane
// starts at step 0, and the inner searches never change a lane that has
// stopped), so each group runs its lane's own loop of the lockstep state
// machine,
//   for (steps = 0; steps < step_cap && active; ++steps) body();
// and gets the lockstep result exactly.
//
// Tensor cores are not used: the one matrix shape they take in fp64
// (mma.sync m8n8k4) multiplies one 8x4 by one 4x8 matrix per warp, and each
// lane here has its own 6x6 matrix and its own vector, so the products are
// 6x6 matrix-vector products, which that shape does not fit.
//
// A problem instance is a struct template Prob<T> derived from
// LaneParams<T> (its parameters: row k of the lane's block at at(k)), that
// supplies
//   using Real = T;  static constexpr int N, NCON, NPARAM;
//   static constexpr bool kExactAlmDelta;
//   T obj(const T* x, const T* lam, T mu);       // full ALM objective
//   void cons(const T* x, T* c);                 // NCON equalities (only
//                                                // called when NCON > 0)
//   void gh(const T* x, const T* lam, T mu, T* g, T (*H)[N], int r);
//       // the gradient, and the Hessian rows of thread r's slots
//       // (H[m][j] = entry (r + m * kGroup, j)); see own_rows
//   T alm_delta(const T* c, const T* lam_old, T mu_old, const T* lam_new,
//               T mu_new) const;                 // if kExactAlmDelta
// (obj, cons and gh may keep a cache of their own between calls). With
// kExactAlmDelta the objective after an ALM round is f + alm_delta (the
// objective is affine in lam and mu); without it, obj is evaluated afresh
// at the new lam and mu. A problem without constraints (NCON = 0) has
// ||c|| = 0, so its first ALM round finishes the lane: plain bound-
// constrained TRON (the JAX package's tron_batched); its NCON-sized arrays
// keep one unused slot.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tron_alm {

constexpr int kThreads = 128;
// threads per lane; chosen by a measured A/B of 2, 4 and 8 on the H100
// (PERF.md)
constexpr int kGroup = 2;
constexpr int kLanesPerBlock = kThreads / kGroup;
static_assert(32 % kGroup == 0, "a group lies inside one warp");

// slots (rows) per thread for an N-row matrix
__host__ __device__ constexpr int slots(int n) {
  return (n + kGroup - 1) / kGroup;
}

// packed index of entry (i, j) of a symmetric matrix
__host__ __device__ constexpr int sym(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// TRON constants (Lin & More)
constexpr double kMu0 = 0.01;
constexpr double kInterpF = 0.1;
constexpr double kExtrapF = 10.0;
constexpr double kEta0 = 1e-4, kEta1 = 0.25, kEta2 = 0.75;
constexpr double kSigma1 = 0.25, kSigma2 = 0.5, kSigma3 = 4.0;
constexpr int kCauchyIters = 22;
constexpr int kExtrapIters = 10;
constexpr int kPrsrchIters = 20;

// sin and cos of one angle: sincos gives the same bits as sin and cos
// called apart (checked on the H100 over the angles of the main path's
// branch batches by exaadmm_tpu_torch/kernel_ab.py), in one argument
// reduction
__device__ __forceinline__ void dsincos(float v, float* s, float* c) {
  sincosf(v, s, c);
}
__device__ __forceinline__ void dsincos(double v, double* s, double* c) {
  sincos(v, s, c);
}
__device__ __forceinline__ float dsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dsqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float dpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double dpow(double a, double b) { return pow(a, b); }

// min/max that propagate NaN like torch.minimum / torch.maximum
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
// torch.clamp(y, min=lo, max=hi)
template <typename T>
__device__ __forceinline__ T clip(T y, T lo, T hi) {
  T a = (y < lo) ? lo : y;
  return (a > hi) ? hi : a;
}

// a[0] b[0] + a[1] b[1] + ... in row order
template <int N, typename T>
__device__ __forceinline__ T dot(const T* a, const T* b) {
  T acc = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < N; ++i) acc = acc + a[i] * b[i];
  return acc;
}

// The kGroup threads of one lane: rank r, and the mask of the group's
// threads in the warp for __shfl_sync.
struct Group {
  unsigned mask;
  int r;
  __device__ __forceinline__ Group() {
    const int wl = static_cast<int>(threadIdx.x & 31u);
    r = wl % kGroup;
    mask = (kGroup == 32 ? 0xffffffffu : ((1u << kGroup) - 1u))
           << (wl - r);
  }
  // v of the group's thread src
  template <typename T>
  __device__ __forceinline__ T from(T v, int src) const {
    return __shfl_sync(mask, v, src, kGroup);
  }
};

// v[i] for the row i = r + m * kGroup of slot m (v[m * kGroup] where that
// row does not exist); m is a compile-time constant after unrolling, so the
// selects keep v in registers
template <int N, typename T>
__device__ __forceinline__ T pick(const T* v, int r, int m) {
  T out = v[m * kGroup];
#pragma unroll
  for (int rr = 1; rr < kGroup; ++rr) {
    if (m * kGroup + rr < N) out = (r == rr) ? v[m * kGroup + rr] : out;
  }
  return out;
}

// thread r's rows of a packed symmetric matrix: H[m][j] = Hp[sym(i, j)],
// i = r + m * kGroup
template <int N, typename T>
__device__ __forceinline__ void own_rows(const T* Hp, int r,
                                         T (*H)[N]) {
#pragma unroll
  for (int m = 0; m < slots(N); ++m) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T out = Hp[sym(m * kGroup, j)];
#pragma unroll
      for (int rr = 1; rr < kGroup; ++rr) {
        if (m * kGroup + rr < N)
          out = (r == rr) ? Hp[sym(m * kGroup + rr, j)] : out;
      }
      H[m][j] = out;
    }
  }
}

// (H s)_i = H[i][0] s[0] + H[i][1] s[1] + ... in column order: each thread
// its own rows, then every row to every thread of the group
template <int N, typename T>
__device__ __forceinline__ void hmatvec(const Group& gp, const T (*H)[N],
                                        const T* s, T* out) {
  T part[slots(N)];
#pragma unroll
  for (int m = 0; m < slots(N); ++m) {
    T acc = H[m][0] * s[0];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + H[m][j] * s[j];
    part[m] = acc;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = gp.from(part[i / kGroup], i % kGroup);
}

// Solve (A + tau I) d = rhs by dense Cholesky on A's rows (thread r holds
// its slots' rows, lower triangle used); rhs and d are replicated. Returns
// false if a pivot is not positive (d is then not written); the test is on
// the pivot every thread received, so the group agrees.
template <int N, typename T>
__device__ __forceinline__ bool chol_solve(const Group& gp, const T (*A)[N],
                                           const T* rhs, T tau, T* d) {
  constexpr int NS = slots(N);
  T L[NS][N];  // L[m][k]: entry (r + m * kGroup, k); read only for k < row
  T inv_diag[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    constexpr int G = kGroup;
    // the pivot, on the thread that holds row j
    T sj = A[j / G][j] + tau;
#pragma unroll
    for (int k = 0; k < j; ++k) sj = sj - L[j / G][k] * L[j / G][k];
    const T s = gp.from(sj, j % G);
    if (!(s > T(0))) return false;
    const T inv_piv = T(1) / dsqrt(s);
    inv_diag[j] = inv_piv;
    if (j + 1 < N) {
      // row j of L to every thread, then each thread its rows below j
      T Lj[N];
#pragma unroll
      for (int k = 0; k < j; ++k) Lj[k] = gp.from(L[j / G][k], j % G);
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        T t = A[m][j];
#pragma unroll
        for (int k = 0; k < j; ++k) t = t - L[m][k] * Lj[k];
        L[m][j] = t * inv_piv;
      }
    }
  }
  // forward substitution, column by column: y[k] from row k's thread, then
  // each thread updates its rows (rows at or above k are not read again)
  T rr[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) rr[m] = pick<N>(rhs, gp.r, m);
  T y[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    y[k] = gp.from(rr[k / kGroup] * inv_diag[k], k % kGroup);
#pragma unroll
    for (int m = 0; m < NS; ++m) rr[m] = rr[m] - L[m][k] * y[k];
  }
  // back substitution: the terms L[k][i] d[k] come from row k's thread and
  // are subtracted in ascending k
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T t = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k)
      t = t - gp.from(L[k / kGroup][i] * d[k], k % kGroup);
    d[i] = t * inv_diag[i];
  }
  return true;
}

// a lane's parameters: row k of its (NPARAM, B) block at at(k)
template <typename T>
struct LaneParams {
  const T* P;
  int stride;
  __device__ __forceinline__ T at(int k) const { return P[k * stride]; }
};

// size of an NCON-long array: one unused slot when NCON = 0
template <int NCON>
constexpr int con_slots = NCON > 0 ? NCON : 1;

template <class Prob, typename T = typename Prob::Real>
struct Lane {
  static constexpr int N = Prob::N;
  T x[N];
  T lam[con_slots<Prob::NCON>];
  T mu;
  const T* bounds;  // xl rows 0..N-1, xu rows N..2N-1, at stride
  int stride;
  Prob p;
  __device__ __forceinline__ T xl(int i) const { return bounds[i * stride]; }
  __device__ __forceinline__ T xu(int i) const {
    return bounds[(N + i) * stride];
  }
};

template <int N, typename T>
__device__ __forceinline__ T qval(const Group& gp, const T* g,
                                  const T (*H)[N], const T* s) {
  T Hs[N];
  hmatvec<N>(gp, H, s, Hs);
  return dot<N>(g, s) + T(0.5) * dot<N>(s, Hs);
}

template <class Prob, typename T = typename Prob::Real>
__device__ __forceinline__ void s_of(const Lane<Prob>& ln, const T* g, T a,
                                     T* s) {
#pragma unroll
  for (int i = 0; i < Prob::N; ++i)
    s[i] = clip(ln.x[i] - a * g[i], ln.xl(i), ln.xu(i)) - ln.x[i];
}

template <class Prob, typename T = typename Prob::Real>
__device__ __forceinline__ bool cauchy_ok(const Group& gp,
                                          const Lane<Prob>& ln, const T* g,
                                          const T (*H)[Prob::N], T delta,
                                          T a) {
  constexpr int N = Prob::N;
  T s[N];
  s_of(ln, g, a, s);
  // both tests, always: their chains then overlap, and no lane's branch
  // holds up the rest of the warp
  const bool inside = dsqrt(dot<N>(s, s)) <= delta;
  const bool decrease = qval<N>(gp, g, H, s) <= T(kMu0) * dot<N>(g, s);
  return inside && decrease;
}

// One trust-region step (tron.py tr_step). Updates x, f, delta and alpha_c;
// returns the frtol test.
template <class Prob, typename T = typename Prob::Real>
__device__ __forceinline__ bool tr_step(const Group& gp, Lane<Prob>& ln,
                                        T& f, const T* g,
                                        const T (*H)[Prob::N], T& delta,
                                        T& alpha_c, T frtol) {
  constexpr int N = Prob::N;
  constexpr int NS = slots(N);
  // --- Cauchy point (dcauchy), warm-started step ---
  const T a0 = (alpha_c < T(1e-30)) ? T(1e-30) : alpha_c;
  const bool need = !cauchy_ok(gp, ln, g, H, delta, a0);
  const T factor = need ? T(kInterpF) : T(kExtrapF);
  T alpha = a0, cand = a0;
#pragma unroll 1
  for (int k = 0; k < kCauchyIters; ++k) {
    cand = cand * factor;
    const bool ok = cauchy_ok(gp, ln, g, H, delta, cand);
    if (need) {
      // interpolation keeps every trial, stops at the first acceptable one
      alpha = cand;
      if (ok) break;
    } else {
      // extrapolation keeps the last acceptable trial
      const bool good = ok && (cand < T(1e12));
      if (good) alpha = cand;
      if (!good || k + 1 >= kExtrapIters) break;
    }
  }
  T sc[N], xc[N];
  s_of(ln, g, alpha, sc);
#pragma unroll
  for (int i = 0; i < N; ++i) xc[i] = ln.x[i] + sc[i];

  // --- Newton direction on the free variables ---
  T freef[N], Hsc[N], gc[N], rhs[N];
  bool free_[N];
  hmatvec<N>(gp, H, sc, Hsc);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    free_[i] = (xc[i] > ln.xl(i)) && (xc[i] < ln.xu(i));
    freef[i] = free_[i] ? T(1) : T(0);
    gc[i] = g[i] + Hsc[i];
    rhs[i] = -(free_[i] ? gc[i] : T(0));
  }
  // the masked Hessian, row by row: H_ij f_i f_j + (i == j ? 1 - f_i : 0)
  T Hm[NS][N];
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    const int i = gp.r + m * kGroup;
    const T fi = pick<N>(freef, gp.r, m);
    const T di = T(1) - fi;
#pragma unroll
    for (int j = 0; j < N; ++j)
      Hm[m][j] = H[m][j] * fi * freef[j] + ((i == j) ? di : T(0));
  }

  T d[N];
  bool solved = chol_solve<N>(gp, Hm, rhs, T(0), d);
  if (!solved) {
    // the shift ladder, in units of max(max_i |Hm_ii|, 1)
    T dmax = T(0);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T hii = T(fabs(gp.from(Hm[i / kGroup][i], i % kGroup)));
      dmax = (i == 0) ? hii : tmax(dmax, hii);
    }
    dmax = (dmax < T(1)) ? T(1) : dmax;
    const double kShifts[5] = {1e-10, 1e-6, 1e-3, 1.0, 1e3};
#pragma unroll 1
    for (int lvl = 0; lvl < 5 && !solved; ++lvl) {
      solved = chol_solve<N>(gp, Hm, rhs, dmax * T(kShifts[lvl]), d);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = (free_[i] && solved) ? d[i] : T(0);

  // clip the combined step to the trust region (dtrqsol)
  const T dd = dot<N>(d, d);
  const T sd = dot<N>(sc, d);
  const T ss = dot<N>(sc, sc);
  T rad = sd * sd + dd * (delta * delta - ss);
  rad = (rad < T(0)) ? T(0) : rad;
  T tau = T(0);
  if (dd > T(0)) {
    tau = (dsqrt(rad) - sd) / dd;
    tau = (tau > T(1)) ? T(1) : tau;
  }
  const T taup = (tau < T(0)) ? T(0) : tau;
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = d[i] * taup;

  // --- projected backtracking from xc along d (dprsrch) ---
  // The first trial (aw = 1) is taken on nearly every step, so the
  // objective at it is evaluated beside its test and the two chains
  // overlap; a lane whose first trial fails searches on and evaluates the
  // objective at the step it ends with.
  const T q_c = dot<N>(g, sc) + T(0.5) * dot<N>(sc, Hsc);
  T s[N], xt[N];
  T aw = T(1);
  T ft, q_s;  // objective at x + s, and the model's qval(s)
  {
    T s_try[N], diff[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s_try[i] = clip(xc[i] + aw * d[i], ln.xl(i), ln.xu(i)) - ln.x[i];
      diff[i] = s_try[i] - sc[i];
      xt[i] = ln.x[i] + s_try[i];
      s[i] = s_try[i];
    }
    T gd = dot<N>(gc, diff);
    gd = (gd > T(0)) ? T(0) : gd;
    ft = ln.p.obj(xt, ln.lam, ln.mu);
    q_s = qval<N>(gp, g, H, s_try);
    if (!(q_s <= q_c + T(kMu0) * gd)) {
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] = sc[i];
      aw = aw * T(0.5);
#pragma unroll 1
      for (int k = 1; k < kPrsrchIters; ++k) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          s_try[i] = clip(xc[i] + aw * d[i], ln.xl(i), ln.xu(i)) - ln.x[i];
          diff[i] = s_try[i] - sc[i];
        }
        gd = dot<N>(gc, diff);
        gd = (gd > T(0)) ? T(0) : gd;
        if (qval<N>(gp, g, H, s_try) <= q_c + T(kMu0) * gd) {
#pragma unroll
          for (int i = 0; i < N; ++i) s[i] = s_try[i];
          break;
        }
        aw = aw * T(0.5);
      }
#pragma unroll
      for (int i = 0; i < N; ++i) xt[i] = ln.x[i] + s[i];
      ft = ln.p.obj(xt, ln.lam, ln.mu);
      q_s = qval<N>(gp, g, H, s);
    }
  }

  // --- ratio test and radius update (dtron) ---
  const T predred = -q_s;
  const T actred = f - ft;
  const T gts = dot<N>(g, s);
  const T snorm = dsqrt(dot<N>(s, s));

  const T denom = ft - f - gts;
  T alpha_q;
  if (denom <= T(0)) {
    alpha_q = T(kSigma3);
  } else {
    alpha_q = T(-0.5) * gts / denom;
    alpha_q = (alpha_q < T(kSigma1)) ? T(kSigma1) : alpha_q;
  }
  const T ratio = (predred > T(0)) ? actred / predred : T(0);

  const T aqs = alpha_q * snorm;
  T delta_new;
  if (ratio <= T(kEta0)) {
    const T aq = (alpha_q < T(kSigma1)) ? T(kSigma1) : alpha_q;
    delta_new = tmin(aq * snorm, T(kSigma2) * delta);
  } else if (ratio < T(kEta1)) {
    delta_new = tmax(T(kSigma1) * delta, tmin(aqs, T(kSigma2) * delta));
  } else if (ratio < T(kEta2)) {
    delta_new = tmax(T(kSigma1) * delta, tmin(aqs, T(kSigma3) * delta));
  } else {
    delta_new = tmax(delta, tmin(aqs, T(kSigma3) * delta));
  }
  delta_new = (delta_new < T(1e-30)) ? T(1e-30) : delta_new;

  const bool accept = ratio > T(kEta0);
  const T fabs_f = fabs(f);
  const bool frtol_conv = (predred <= T(frtol) * fabs_f) ||
                          (accept && (actred <= T(frtol) * fabs_f));
  if (accept) {
#pragma unroll
    for (int i = 0; i < N; ++i) ln.x[i] = xt[i];
    f = ft;
  }
  delta = delta_new;
  alpha_c = alpha;
  return frtol_conv;
}

template <class Prob, typename T = typename Prob::Real>
__global__ void __launch_bounds__(kThreads, kGroup)
    tron_alm_kernel(const T* __restrict__ x0, const T* __restrict__ xl,
                    const T* __restrict__ xu, const T* __restrict__ P,
                    const T* __restrict__ lam0, const T* __restrict__ mu0,
                    const unsigned char* __restrict__ active0,
                    T* __restrict__ x_out, T* __restrict__ lam_out,
                    T* __restrict__ mu_out, int* __restrict__ minor_out,
                    int* __restrict__ alm_out, T* __restrict__ cviol_out,
                    int B, T gtol, T frtol, T ctol, T mu_max, int max_minor,
                    int max_auglag, int step_cap) {
  constexpr int N = Prob::N;
  constexpr int NCON = Prob::NCON;
  constexpr int NP = Prob::NPARAM;
  // the lanes' parameters, then xl and xu, rows of kLanesPerBlock
  __shared__ T shared[(NP + 2 * N) * kLanesPerBlock];

  const Group gp;
  const int slot = static_cast<int>(threadIdx.x) / kGroup;
  const int lane = static_cast<int>(blockIdx.x) * kLanesPerBlock + slot;
  if (lane >= B) return;  // the whole group leaves together

  T* mine = shared + slot;
#pragma unroll 1
  for (int k = gp.r; k < NP; k += kGroup)
    mine[k * kLanesPerBlock] = P[static_cast<size_t>(k) * B + lane];
#pragma unroll 1
  for (int i = gp.r; i < N; i += kGroup) {
    mine[(NP + i) * kLanesPerBlock] = xl[i * B + lane];
    mine[(NP + N + i) * kLanesPerBlock] = xu[i * B + lane];
  }
  __syncwarp(gp.mask);

  Lane<Prob> ln;
#pragma unroll
  for (int i = 0; i < N; ++i) ln.x[i] = x0[i * B + lane];
#pragma unroll
  for (int i = 0; i < NCON; ++i) ln.lam[i] = lam0[i * B + lane];
  ln.mu = mu0[lane];
  ln.bounds = mine + NP * kLanesPerBlock;
  ln.stride = kLanesPerBlock;
  ln.p.P = mine;
  ln.p.stride = kLanesPerBlock;

  bool active = active0[lane] != 0;
  T f = active ? ln.p.obj(ln.x, ln.lam, ln.mu) : T(0);
  T delta = T(0), alpha_c = T(1);
  int tron_it = 0, alm_it = 0, minor_total = 0;
  bool tron_done = false, need_init = true;
  T eta = T(1) / dpow(ln.mu, T(0.1));
  T cviol = T(INFINITY);

#pragma unroll 1
  for (int steps = 0; steps < step_cap && active; ++steps) {
    T g[N], H[slots(N)][N];
    ln.p.gh(ln.x, ln.lam, ln.mu, g, H, gp.r);

    if (need_init) {
      const T gnorm = dsqrt(dot<N>(g, g));
      delta = (gnorm < T(1e-12)) ? T(1e-12) : gnorm;
      alpha_c = T(1);
    }
    // projected-gradient inf-norm
    T gpn = T(0);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T gp_i = g[i];
      if (ln.x[i] <= ln.xl(i)) gp_i = (gp_i > T(0)) ? T(0) : gp_i;
      if (ln.x[i] >= ln.xu(i)) gp_i = (gp_i < T(0)) ? T(0) : gp_i;
      gpn = tmax(gpn, T(fabs(gp_i)));
    }
    const bool tron_conv = gpn <= gtol;
    const bool open = !tron_done;
    const bool stepping = open && !tron_conv && (tron_it < max_minor);
    const bool newly_done = open && (tron_conv || tron_it >= max_minor);

    bool frtol_conv = false;
    if (stepping) {
      frtol_conv = tr_step(gp, ln, f, g, H, delta, alpha_c, frtol);
      ++tron_it;
      ++minor_total;
      need_init = false;
    }
    tron_done = tron_done || newly_done || (stepping && frtol_conv);
    if (!tron_done) continue;

    // --- ALM round at the new x ---
    T c[con_slots<NCON>];
    T cnorm = T(0);  // without constraints the round solves the lane
    if constexpr (NCON > 0) {
      ln.p.cons(ln.x, c);
      cnorm = T(fabs(c[0]));
#pragma unroll
      for (int i = 1; i < NCON; ++i) cnorm = tmax(cnorm, T(fabs(c[i])));
    }
    const bool good = cnorm <= eta;
    const bool lane_solved = good && (cnorm <= ctol);
    T lam_old[con_slots<NCON>];
#pragma unroll
    for (int i = 0; i < NCON; ++i) lam_old[i] = ln.lam[i];
    const T mu_old = ln.mu;
    if (good && !lane_solved) {
#pragma unroll
      for (int i = 0; i < NCON; ++i) ln.lam[i] = ln.lam[i] + mu_old * c[i];
    }
    if (!good) {
      const T m10 = mu_old * T(10);
      ln.mu = (m10 > mu_max) ? mu_max : m10;
    }
    if (!lane_solved) {
      // eta / mu_old^0.9 after a multiplier update, 1 / mu^0.1 after a
      // penalty update: one pow call for both, so lanes of a warp that
      // take different updates run one pow and not two in turn
      const T p = dpow(good ? mu_old : ln.mu, good ? T(0.9) : T(0.1));
      eta = good ? eta / p : T(1) / p;
    }
    ++alm_it;
    if (lane_solved || alm_it >= max_auglag) {
      active = false;
    } else {
      tron_done = false;
      tron_it = 0;
      need_init = true;
      if constexpr (Prob::kExactAlmDelta) {
        f = f + ln.p.alm_delta(c, lam_old, mu_old, ln.lam, ln.mu);
      } else {
        f = ln.p.obj(ln.x, ln.lam, ln.mu);
      }
    }
    cviol = cnorm;
  }

  // every thread holds the result; each writes its own rows
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i % kGroup == gp.r) x_out[i * B + lane] = ln.x[i];
  if (gp.r == 0) {
#pragma unroll
    for (int i = 0; i < NCON; ++i) lam_out[i * B + lane] = ln.lam[i];
    mu_out[lane] = ln.mu;
    minor_out[lane] = minor_total;
    alm_out[lane] = alm_it;
    cviol_out[lane] = cviol;
  }
}

// Launch the batch on ``stream``; returns cudaGetLastError() as int.
template <class Prob, typename T = typename Prob::Real>
int launch(const void* x0, const void* xl, const void* xu, const void* P,
           const void* lam0, const void* mu0, const void* active0, void* x,
           void* lam, void* mu, void* minor, void* alm, void* cviol, int B,
           double gtol, double frtol, double ctol, double mu_max,
           int max_minor, int max_auglag, int step_cap, void* stream) {
  if (B > 0) {
    const unsigned blocks =
        static_cast<unsigned>((B + kLanesPerBlock - 1) / kLanesPerBlock);
    tron_alm_kernel<Prob><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x0), static_cast<const T*>(xl),
        static_cast<const T*>(xu), static_cast<const T*>(P),
        static_cast<const T*>(lam0), static_cast<const T*>(mu0),
        static_cast<const unsigned char*>(active0), static_cast<T*>(x),
        static_cast<T*>(lam), static_cast<T*>(mu), static_cast<int*>(minor),
        static_cast<int*>(alm), static_cast<T*>(cviol), B, T(gtol), T(frtol),
        T(ctol), T(mu_max), max_minor, max_auglag, step_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tron_alm

// The extern "C" entry points of one instance: <name>_f64 and <name>_f32
// (pointers and the stream as void*), plus error_string.
#define TRON_ALM_ENTRY_POINTS(name, Prob)                                    \
  extern "C" {                                                               \
  int name##_f64(const void* x0, const void* xl, const void* xu,            \
                 const void* P, const void* lam0, const void* mu0,          \
                 const void* active0, void* x, void* lam, void* mu,         \
                 void* minor, void* alm, void* cviol, int B, double gtol,   \
                 double frtol, double ctol, double mu_max, int max_minor,   \
                 int max_auglag, int step_cap, void* stream) {              \
    return tron_alm::launch<Prob<double>>(                                   \
        x0, xl, xu, P, lam0, mu0, active0, x, lam, mu, minor, alm, cviol,    \
        B, gtol, frtol, ctol, mu_max, max_minor, max_auglag, step_cap,       \
        stream);                                                             \
  }                                                                          \
  int name##_f32(const void* x0, const void* xl, const void* xu,            \
                 const void* P, const void* lam0, const void* mu0,          \
                 const void* active0, void* x, void* lam, void* mu,         \
                 void* minor, void* alm, void* cviol, int B, double gtol,   \
                 double frtol, double ctol, double mu_max, int max_minor,   \
                 int max_auglag, int step_cap, void* stream) {              \
    return tron_alm::launch<Prob<float>>(                                    \
        x0, xl, xu, P, lam0, mu0, active0, x, lam, mu, minor, alm, cviol,    \
        B, gtol, frtol, ctol, mu_max, max_minor, max_auglag, step_cap,       \
        stream);                                                             \
  }                                                                          \
  const char* error_string(int err) {                                        \
    return cudaGetErrorString(static_cast<cudaError_t>(err));                \
  }                                                                          \
  }
