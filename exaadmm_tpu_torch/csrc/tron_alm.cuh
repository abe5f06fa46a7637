// TRON/ALM batch body, shared by every problem instance: one small
// bound-constrained subproblem per thread.
//
// Replaces: exaadmm_tpu/ops/tron_pallas.py::tron_alm_batched_pallas, whose
// body is exaadmm_tpu/ops/tron.py::tron_alm_batched. The plain version it is
// checked against is exaadmm_tpu_torch/ops/tron.py::tron_alm_batched.
//
// What bounds it on the H100: registers and latency, not bytes. A lane reads
// a few dozen values and writes a few, but between them it runs tens to
// hundreds of trust-region steps, each a closed-form gradient and Hessian, a
// Cauchy search, up to six dense Cholesky factorizations and a projected
// search, all in dependent scalar arithmetic.
//
// Design: one thread per lane, blocks of 128 threads, no shared memory and
// no __syncthreads, so a lane that finishes early just exits. Each thread
// runs its lane's own loop of the lockstep state machine,
//   for (steps = 0; steps < step_cap && active; ++steps) body();
// which gives the lockstep result exactly, because every lane's trajectory
// in tron.py is independent of the others: every lane starts at step 0, and
// the inner searches (Cauchy, projected search, shift ladder) never change a
// lane that has stopped. Inputs and outputs keep the (n, B) rows layout, so
// neighbouring threads read neighbouring addresses. Symmetric matrices are
// stored packed (N (N + 1) / 2 entries) and every small loop is unrolled, so
// indices are compile-time constants and the arrays can live in registers.
//
// Every expression repeats the plain version's operation order, and the
// libraries are compiled with --fmad=false, so the arithmetic follows the
// plain version op for op (no fused multiply-adds).
//
// A problem instance is a struct template Prob<T> that holds one lane's
// parameters and supplies
//   using Real = T;  static constexpr int N, NCON, NPARAM;
//   static constexpr bool kExactAlmDelta;
//   void load(const T* P, int lane, int B);      // rows of the (NPARAM, B)
//   T obj(const T* x, const T* lam, T mu) const; // full ALM objective
//   void cons(const T* x, T* c) const;           // NCON equalities
//   void gh(const T* x, const T* lam, T mu, T* g, T* H) const;  // packed H
//   T alm_delta(const T* c, const T* lam_old, T mu_old, const T* lam_new,
//               T mu_new) const;                 // if kExactAlmDelta
// With kExactAlmDelta the objective after an ALM round is f + alm_delta
// (the objective is affine in lam and mu); without it, obj is evaluated
// afresh at the new lam and mu.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tron_alm {

constexpr int kThreads = 128;

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

__device__ __forceinline__ float dcos(float v) { return cosf(v); }
__device__ __forceinline__ double dcos(double v) { return cos(v); }
__device__ __forceinline__ float dsin(float v) { return sinf(v); }
__device__ __forceinline__ double dsin(double v) { return sin(v); }
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

// (H s)_i = H[i][0] s[0] + H[i][1] s[1] + ... in column order
template <int N, typename T>
__device__ __forceinline__ void hmatvec(const T* H, const T* s, T* out) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = H[sym(i, 0)] * s[0];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + H[sym(i, j)] * s[j];
    out[i] = acc;
  }
}

// Solve (H + tau I) d = rhs by dense Cholesky on the packed lower triangle.
// Returns false if a pivot is not positive (d is then not written).
template <int N, typename T>
__device__ __forceinline__ bool chol_solve(const T* H, const T* rhs, T tau,
                                           T* d) {
  T L[N * (N + 1) / 2];
  T inv_diag[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T s = H[sym(j, j)] + tau;
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[sym(j, k)] * L[sym(j, k)];
    if (!(s > T(0))) return false;
    const T inv_piv = T(1) / dsqrt(s);
    inv_diag[j] = inv_piv;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      T t = H[sym(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[sym(i, k)] * L[sym(j, k)];
      L[sym(i, j)] = t * inv_piv;
    }
  }
  T r[N], y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = rhs[i];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    y[k] = r[k] * inv_diag[k];
#pragma unroll
    for (int i = k + 1; i < N; ++i) r[i] = r[i] - L[sym(i, k)] * y[k];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T t = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) t = t - L[sym(k, i)] * d[k];
    d[i] = t * inv_diag[i];
  }
  return true;
}

template <class Prob, typename T = typename Prob::Real>
struct Lane {
  T x[Prob::N], xl[Prob::N], xu[Prob::N];
  T lam[Prob::NCON];
  T mu;
  Prob p;
};

template <int N, typename T>
__device__ __forceinline__ T qval(const T* g, const T* H, const T* s) {
  T Hs[N];
  hmatvec<N>(H, s, Hs);
  return dot<N>(g, s) + T(0.5) * dot<N>(s, Hs);
}

template <class Prob, typename T = typename Prob::Real>
__device__ __forceinline__ void s_of(const Lane<Prob>& ln, const T* g, T a,
                                     T* s) {
#pragma unroll
  for (int i = 0; i < Prob::N; ++i)
    s[i] = clip(ln.x[i] - a * g[i], ln.xl[i], ln.xu[i]) - ln.x[i];
}

template <class Prob, typename T = typename Prob::Real>
__device__ __forceinline__ bool cauchy_ok(const Lane<Prob>& ln, const T* g,
                                          const T* H, T delta, T a) {
  constexpr int N = Prob::N;
  T s[N];
  s_of(ln, g, a, s);
  return (dsqrt(dot<N>(s, s)) <= delta) &&
         (qval<N>(g, H, s) <= T(kMu0) * dot<N>(g, s));
}

// One trust-region step (tron.py tr_step). Updates x, f, delta and alpha_c;
// returns the frtol test.
template <class Prob, typename T = typename Prob::Real>
__device__ __forceinline__ bool tr_step(Lane<Prob>& ln, T& f, const T* g,
                                        const T* H, T& delta, T& alpha_c,
                                        T frtol) {
  constexpr int N = Prob::N;
  constexpr int NS = N * (N + 1) / 2;
  // --- Cauchy point (dcauchy), warm-started step ---
  const T a0 = (alpha_c < T(1e-30)) ? T(1e-30) : alpha_c;
  const bool need = !cauchy_ok(ln, g, H, delta, a0);
  const T factor = need ? T(kInterpF) : T(kExtrapF);
  T alpha = a0, cand = a0;
#pragma unroll 1
  for (int k = 0; k < kCauchyIters; ++k) {
    cand = cand * factor;
    const bool ok = cauchy_ok(ln, g, H, delta, cand);
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
  hmatvec<N>(H, sc, Hsc);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    free_[i] = (xc[i] > ln.xl[i]) && (xc[i] < ln.xu[i]);
    freef[i] = free_[i] ? T(1) : T(0);
    gc[i] = g[i] + Hsc[i];
    rhs[i] = -(free_[i] ? gc[i] : T(0));
  }
  T Hm[NS];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      Hm[sym(i, j)] = H[sym(i, j)] * freef[i] * freef[j] +
                      (i == j ? (T(1) - freef[i]) : T(0));
    }
  }
  T dmax = fabs(Hm[sym(0, 0)]);
#pragma unroll
  for (int i = 1; i < N; ++i) dmax = tmax(dmax, T(fabs(Hm[sym(i, i)])));
  dmax = (dmax < T(1)) ? T(1) : dmax;

  T d[N];
  bool solved = chol_solve<N>(Hm, rhs, T(0), d);
  if (!solved) {
    const double kShifts[5] = {1e-10, 1e-6, 1e-3, 1.0, 1e3};
#pragma unroll 1
    for (int lvl = 0; lvl < 5 && !solved; ++lvl) {
      solved = chol_solve<N>(Hm, rhs, dmax * T(kShifts[lvl]), d);
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
  const T q_c = dot<N>(g, sc) + T(0.5) * dot<N>(sc, Hsc);
  T s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = sc[i];
  T aw = T(1);
#pragma unroll 1
  for (int k = 0; k < kPrsrchIters; ++k) {
    T s_try[N], diff[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s_try[i] = clip(xc[i] + aw * d[i], ln.xl[i], ln.xu[i]) - ln.x[i];
      diff[i] = s_try[i] - sc[i];
    }
    T gd = dot<N>(gc, diff);
    gd = (gd > T(0)) ? T(0) : gd;
    if (qval<N>(g, H, s_try) <= q_c + T(kMu0) * gd) {
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] = s_try[i];
      break;
    }
    aw = aw * T(0.5);
  }

  // --- ratio test and radius update (dtron) ---
  T xt[N];
#pragma unroll
  for (int i = 0; i < N; ++i) xt[i] = ln.x[i] + s[i];
  const T ft = ln.p.obj(xt, ln.lam, ln.mu);
  const T predred = -qval<N>(g, H, s);
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
__global__ void __launch_bounds__(kThreads)
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
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;

  Lane<Prob> ln;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ln.x[i] = x0[i * B + lane];
    ln.xl[i] = xl[i * B + lane];
    ln.xu[i] = xu[i * B + lane];
  }
#pragma unroll
  for (int i = 0; i < NCON; ++i) ln.lam[i] = lam0[i * B + lane];
  ln.mu = mu0[lane];
  ln.p.load(P, lane, B);

  bool active = active0[lane] != 0;
  T f = active ? ln.p.obj(ln.x, ln.lam, ln.mu) : T(0);
  T delta = T(0), alpha_c = T(1);
  int tron_it = 0, alm_it = 0, minor_total = 0;
  bool tron_done = false, need_init = true;
  T eta = T(1) / dpow(ln.mu, T(0.1));
  T cviol = T(INFINITY);

#pragma unroll 1
  for (int steps = 0; steps < step_cap && active; ++steps) {
    T g[N], H[N * (N + 1) / 2];
    ln.p.gh(ln.x, ln.lam, ln.mu, g, H);

    if (need_init) {
      const T gnorm = dsqrt(dot<N>(g, g));
      delta = (gnorm < T(1e-12)) ? T(1e-12) : gnorm;
      alpha_c = T(1);
    }
    // projected-gradient inf-norm
    T gpn = T(0);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T gp = g[i];
      if (ln.x[i] <= ln.xl[i]) gp = (gp > T(0)) ? T(0) : gp;
      if (ln.x[i] >= ln.xu[i]) gp = (gp < T(0)) ? T(0) : gp;
      gpn = tmax(gpn, T(fabs(gp)));
    }
    const bool tron_conv = gpn <= gtol;
    const bool open = !tron_done;
    const bool stepping = open && !tron_conv && (tron_it < max_minor);
    const bool newly_done = open && (tron_conv || tron_it >= max_minor);

    bool frtol_conv = false;
    if (stepping) {
      frtol_conv = tr_step(ln, f, g, H, delta, alpha_c, frtol);
      ++tron_it;
      ++minor_total;
      need_init = false;
    }
    tron_done = tron_done || newly_done || (stepping && frtol_conv);
    if (!tron_done) continue;

    // --- ALM round at the new x ---
    T c[NCON];
    ln.p.cons(ln.x, c);
    T cnorm = T(fabs(c[0]));
#pragma unroll
    for (int i = 1; i < NCON; ++i) cnorm = tmax(cnorm, T(fabs(c[i])));
    const bool good = cnorm <= eta;
    const bool lane_solved = good && (cnorm <= ctol);
    T lam_old[NCON];
#pragma unroll
    for (int i = 0; i < NCON; ++i) lam_old[i] = ln.lam[i];
    const T mu_old = ln.mu;
    if (good && !lane_solved) {
#pragma unroll
      for (int i = 0; i < NCON; ++i) ln.lam[i] = ln.lam[i] + mu_old * c[i];
      eta = eta / dpow(mu_old, T(0.9));
    }
    if (!good) {
      const T m10 = mu_old * T(10);
      ln.mu = (m10 > mu_max) ? mu_max : m10;
      eta = T(1) / dpow(ln.mu, T(0.1));
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

#pragma unroll
  for (int i = 0; i < N; ++i) x_out[i * B + lane] = ln.x[i];
#pragma unroll
  for (int i = 0; i < NCON; ++i) lam_out[i * B + lane] = ln.lam[i];
  mu_out[lane] = ln.mu;
  minor_out[lane] = minor_total;
  alm_out[lane] = alm_it;
  cviol_out[lane] = cviol;
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
        static_cast<unsigned>((B + kThreads - 1) / kThreads);
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
