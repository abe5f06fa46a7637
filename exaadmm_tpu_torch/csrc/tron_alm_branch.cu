// Branch TRON/ALM batch: one 6-variable line subproblem per thread.
//
// Replaces: exaadmm_tpu/ops/tron_pallas.py::tron_alm_batched_pallas, whose
// body is exaadmm_tpu/ops/tron.py::tron_alm_batched, for the ACOPF branch
// instance (n = 6, ncon = 2, branch_fgh_linelimit and branch_alm_delta of
// exaadmm_tpu/models/acopf/branch.py). The plain version it is checked
// against is exaadmm_tpu_torch/ops/tron.py::tron_alm_batched with the
// functions of exaadmm_tpu_torch/models/acopf/branch.py.
//
// What bounds it on the H100: registers and latency, not bytes. A lane reads
// about 60 values and writes 12, but between them it runs tens to hundreds
// of trust-region steps, each a closed-form gradient and 6x6 Hessian, a
// Cauchy search, up to six dense Cholesky factorizations and a projected
// search, all in dependent scalar arithmetic. The lane holds x, g, the
// symmetric Hessian, its masked copy and the Cholesky factor; in fp64 that
// is more than the register file gives a thread, so some of it spills to
// local memory (nvcc -Xptxas -v reports how much).
//
// Design: one thread per lane (line), blocks of 128 threads, no shared
// memory and no __syncthreads, so a lane that finishes early just exits.
// Each thread runs its lane's own loop of the lockstep state machine,
//   for (steps = 0; steps < step_cap && active; ++steps) body();
// which gives the lockstep result exactly, because every lane's trajectory
// in tron.py is independent of the others: every lane starts at step 0, and
// the inner searches (Cauchy, projected search, shift ladder) never change a
// lane that has stopped. Inputs and outputs keep the (n, B) rows layout, so
// neighbouring threads read neighbouring addresses. Symmetric matrices are
// stored packed (21 entries) and every small loop is unrolled, so indices
// are compile-time constants and the arrays can live in registers.
//
// Every expression repeats the plain version's operation order, and the
// library is compiled with --fmad=false, so the arithmetic follows the plain
// version op for op (no fused multiply-adds).
//
// C interface (no PyTorch headers): pointers and the stream as void*, every
// entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int N = 6;
constexpr int NS = N * (N + 1) / 2;  // packed symmetric size

// packed index of entry (i, j) of a symmetric 6x6 matrix
__host__ __device__ constexpr int sym(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// structural nonzeros of the flow coefficient rows K[m][b]: column 0 is
// (YffR, -YffI, 0, 0), column 1 is (0, 0, YttR, -YttI), columns 2 and 3 full
__host__ __device__ constexpr bool knz(int m, int b) {
  return b == 0 ? m < 2 : (b == 1 ? m >= 2 : true);
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

// per-line parameters: rows of the packed (33, B) block
template <typename T>
struct Params {
  T YffR, YffI, YftR, YftI, YttR, YttI, YtfR, YtfI;
  T l[8], rho[8], t[8];
  T scale;
};

template <typename T>
__device__ __forceinline__ T dot6(const T* a, const T* b) {
  T acc = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < N; ++i) acc = acc + a[i] * b[i];
  return acc;
}

template <typename T>
__device__ __forceinline__ void hmatvec(const T* H, const T* s, T* out) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = H[sym(i, 0)] * s[0];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + H[sym(i, j)] * s[j];
    out[i] = acc;
  }
}

template <typename T>
__device__ __forceinline__ void flows(const T* x, const Params<T>& p, T& pij,
                                      T& qij, T& pji, T& qji) {
  const T vi = x[0], vj = x[1];
  const T cos_ij = dcos(x[2] - x[3]);
  const T sin_ij = dsin(x[2] - x[3]);
  const T vv_cos = vi * vj * cos_ij;
  const T vv_sin = vi * vj * sin_ij;
  const T vi2 = vi * vi;
  const T vj2 = vj * vj;
  pij = p.YffR * vi2 + p.YftR * vv_cos + p.YftI * vv_sin;
  qij = (-p.YffI) * vi2 - p.YftI * vv_cos + p.YftR * vv_sin;
  pji = p.YttR * vj2 + p.YtfR * vv_cos - p.YtfI * vv_sin;
  qji = (-p.YttI) * vj2 - p.YtfI * vv_cos - p.YtfR * vv_sin;
}

// branch_obj_linelimit: the full ALM objective times scale
template <typename T>
__device__ __forceinline__ T branch_obj(const T* x, const Params<T>& p, const T* lam, T mu) {
  T pij, qij, pji, qji;
  flows(x, p, pij, qij, pji, qji);
  const T w[8] = {pij, qij, pji, qji, x[0] * x[0], x[1] * x[1], x[2], x[3]};
  T f = T(0);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const T dw = w[k] - p.t[k];
    f = f + p.l[k] * w[k] + T(0.5) * p.rho[k] * (dw * dw);
  }
  const T c1 = pij * pij + qij * qij + x[4];
  const T c2 = pji * pji + qji * qji + x[5];
  f = f + lam[0] * c1 + lam[1] * c2 + T(0.5) * mu * (c1 * c1 + c2 * c2);
  return f * p.scale;
}

template <typename T>
__device__ __forceinline__ void branch_cons(const T* x, const Params<T>& p,
                                            T* c) {
  T pij, qij, pji, qji;
  flows(x, p, pij, qij, pji, qji);
  c[0] = pij * pij + qij * qij + x[4];
  c[1] = pji * pji + qji * qji + x[5];
}

// branch_fgh_linelimit without f: gradient g and packed Hessian H
template <typename T>
__device__ __forceinline__ void branch_gh(const T* x, const Params<T>& p, const T* lam, T mu,
                          T* g, T* H) {
  const T vi = x[0], vj = x[1], ti = x[2], tj = x[3], s1 = x[4], s2 = x[5];
  const T c_ = dcos(ti - tj);
  const T s_ = dsin(ti - tj);
  const T u1 = vi * vi, u2 = vj * vj;
  const T u3 = vi * vj * c_;
  const T u4 = vi * vj * s_;

  // flow coefficient rows K_m over the basis (u1, u2, u3, u4); knz marks
  // the structural nonzeros, the only terms of every sum below
  const T K[4][4] = {{p.YffR, T(0), p.YftR, p.YftI},
                     {-p.YffI, T(0), -p.YftI, p.YftR},
                     {T(0), p.YttR, p.YtfR, -p.YtfI},
                     {T(0), -p.YttI, -p.YtfI, -p.YtfR}};
  const T u[4] = {u1, u2, u3, u4};
  T F[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    T acc = T(0);
    bool have = false;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (knz(m, b)) {
        const T term = K[m][b] * u[b];
        acc = have ? acc + term : term;
        have = true;
      }
    }
    F[m] = acc;
  }

  const T c1 = F[0] * F[0] + F[1] * F[1] + s1;
  const T c2v = F[2] * F[2] + F[3] * F[3] + s2;
  const T kap1 = lam[0] + mu * c1;
  const T kap2 = lam[1] + mu * c2v;

  // flow adjoints and direct terms
  const T gF[4] = {
      p.l[0] + p.rho[0] * (F[0] - p.t[0]) + T(2) * kap1 * F[0],
      p.l[1] + p.rho[1] * (F[1] - p.t[1]) + T(2) * kap1 * F[1],
      p.l[2] + p.rho[2] * (F[2] - p.t[2]) + T(2) * kap2 * F[2],
      p.l[3] + p.rho[3] * (F[3] - p.t[3]) + T(2) * kap2 * F[3]};
  const T h_u1 = p.l[4] + p.rho[4] * (u1 - p.t[4]);
  const T h_u2 = p.l[5] + p.rho[5] * (u2 - p.t[5]);
  const T h_ti = p.l[6] + p.rho[6] * (ti - p.t[6]);
  const T h_tj = p.l[7] + p.rho[7] * (tj - p.t[7]);

  // basis adjoints a_b = sum_m gF_m K[m][b] (+ direct u terms)
  T a[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    T acc = T(0);
    bool have = false;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (knz(m, b)) {
        const T term = gF[m] * K[m][b];
        acc = have ? acc + term : term;
        have = true;
      }
    }
    a[b] = acc;
  }
  a[0] = a[0] + h_u1;
  a[1] = a[1] + h_u2;

  const T scale = p.scale;
  g[0] = (T(2) * vi * a[0] + vj * c_ * a[2] + vj * s_ * a[3]) * scale;
  g[1] = (T(2) * vj * a[1] + vi * c_ * a[2] + vi * s_ * a[3]) * scale;
  g[2] = ((-u4) * a[2] + u3 * a[3] + h_ti) * scale;
  g[3] = (u4 * a[2] - u3 * a[3] + h_tj) * scale;
  g[4] = kap1 * scale;
  g[5] = kap2 * scale;

  // M over the basis: K^T diag(rho_m + 2 kap_blk) K
  //                   + mu (K^T w1)(K^T w1)^T + mu (K^T w2)(K^T w2)^T
  //                   + diag(rho4, rho5, 0, 0)
  const T rt[4] = {p.rho[0] + T(2) * kap1, p.rho[1] + T(2) * kap1,
                   p.rho[2] + T(2) * kap2, p.rho[3] + T(2) * kap2};
  T kw1[4], kw2[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    T acc1 = T(0), acc2 = T(0);
    bool have1 = false, have2 = false;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (knz(m, b)) {
        const T term = F[m] * K[m][b];
        acc1 = have1 ? acc1 + term : term;
        have1 = true;
      }
      if (knz(m + 2, b)) {
        const T term = F[m + 2] * K[m + 2][b];
        acc2 = have2 ? acc2 + term : term;
        have2 = true;
      }
    }
    kw1[b] = T(2) * acc1;
    kw2[b] = T(2) * acc2;
  }
  T M[4][4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int b2 = b; b2 < 4; ++b2) {
      T acc = T(0);
      bool have = false;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (knz(m, b) && knz(m, b2)) {
          const T term = rt[m] * K[m][b] * K[m][b2];
          acc = have ? acc + term : term;
          have = true;
        }
      }
      acc = acc + mu * (kw1[b] * kw1[b2] + kw2[b] * kw2[b2]);
      M[b][b2] = acc;
      M[b2][b] = acc;
    }
  }
  M[0][0] = M[0][0] + p.rho[4];
  M[1][1] = M[1][1] + p.rho[5];

  // basis Jacobian entries over (vi, vj, ti, tj)
  const T jv0 = T(2) * vi, jv1 = T(2) * vj;
  const T jc0 = vj * c_, jc1 = vi * c_;
  const T js0 = vj * s_, js1 = vi * s_;
  // T = M @ Ju over the structural nonzeros (column 3 is minus column 2)
  T Tm[4][3];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    Tm[b][0] = M[b][0] * jv0 + M[b][2] * jc0 + M[b][3] * js0;
    Tm[b][1] = M[b][1] * jv1 + M[b][2] * jc1 + M[b][3] * js1;
    Tm[b][2] = (-M[b][2]) * u4 + M[b][3] * u3;
  }
  // H4 = Ju^T T, upper triangle
  T H4[4][4];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    H4[0][j] = jv0 * Tm[0][j] + jc0 * Tm[2][j] + js0 * Tm[3][j];
    H4[1][j] = jv1 * Tm[1][j] + jc1 * Tm[2][j] + js1 * Tm[3][j];
    H4[2][j] = (-u4) * Tm[2][j] + u3 * Tm[3][j];
  }
  H4[0][3] = -H4[0][2];
  H4[1][3] = -H4[1][2];
  H4[2][3] = -H4[2][2];
  H4[3][3] = H4[2][2];

  // curvature of the basis: sum_b a_b grad^2 u_b
  H4[0][0] = H4[0][0] + T(2) * a[0];
  H4[1][1] = H4[1][1] + T(2) * a[1];
  H4[0][1] = H4[0][1] + a[2] * c_ + a[3] * s_;
  H4[0][2] = H4[0][2] - a[2] * vj * s_ + a[3] * vj * c_;
  H4[0][3] = H4[0][3] + a[2] * vj * s_ - a[3] * vj * c_;
  H4[1][2] = H4[1][2] - a[2] * vi * s_ + a[3] * vi * c_;
  H4[1][3] = H4[1][3] + a[2] * vi * s_ - a[3] * vi * c_;
  H4[2][2] = H4[2][2] - a[2] * u3 - a[3] * u4 + p.rho[6];
  H4[2][3] = H4[2][3] + a[2] * u3 + a[3] * u4;
  H4[3][3] = H4[3][3] - a[2] * u3 - a[3] * u4 + p.rho[7];

  // cross terms with the slacks: d kap_blk / dx = mu * Ju^T kw_blk
  const T cross1[4] = {mu * (jv0 * kw1[0] + jc0 * kw1[2] + js0 * kw1[3]),
                       mu * (jv1 * kw1[1] + jc1 * kw1[2] + js1 * kw1[3]),
                       mu * ((-u4) * kw1[2] + u3 * kw1[3]),
                       mu * (u4 * kw1[2] + (-u3) * kw1[3])};
  const T cross2[4] = {mu * (jv0 * kw2[0] + jc0 * kw2[2] + js0 * kw2[3]),
                       mu * (jv1 * kw2[1] + jc1 * kw2[2] + js1 * kw2[3]),
                       mu * ((-u4) * kw2[2] + u3 * kw2[3]),
                       mu * (u4 * kw2[2] + (-u3) * kw2[3])};

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = i; j < 4; ++j) H[sym(i, j)] = H4[i][j] * scale;
    H[sym(i, 4)] = cross1[i] * scale;
    H[sym(i, 5)] = cross2[i] * scale;
  }
  H[sym(4, 4)] = mu * scale;
  H[sym(5, 5)] = mu * scale;
  H[sym(4, 5)] = T(0);
}

// Solve (H + tau I) d = rhs by dense Cholesky on the packed lower triangle.
// Returns false if a pivot is not positive (d is then not written).
template <typename T>
__device__ __forceinline__ bool chol_solve(const T* H, const T* rhs, T tau, T* d) {
  T L[NS];
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

template <typename T>
struct Lane {
  T x[N], xl[N], xu[N];
  T lam[2];
  T mu;
  Params<T> p;
};

template <typename T>
__device__ __forceinline__ T qval(const T* g, const T* H, const T* s) {
  T Hs[N];
  hmatvec(H, s, Hs);
  return dot6(g, s) + T(0.5) * dot6(s, Hs);
}

template <typename T>
__device__ __forceinline__ void s_of(const Lane<T>& ln, const T* g, T a,
                                     T* s) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    s[i] = clip(ln.x[i] - a * g[i], ln.xl[i], ln.xu[i]) - ln.x[i];
}

template <typename T>
__device__ __forceinline__ bool cauchy_ok(const Lane<T>& ln, const T* g,
                                          const T* H, T delta, T a) {
  T s[N];
  s_of(ln, g, a, s);
  return (dsqrt(dot6(s, s)) <= delta) &&
         (qval(g, H, s) <= T(kMu0) * dot6(g, s));
}

// One trust-region step (tron.py tr_step). Updates x, f, delta and alpha_c;
// returns the frtol test.
template <typename T>
__device__ __forceinline__ bool tr_step(Lane<T>& ln, T& f, const T* g, const T* H, T& delta,
                        T& alpha_c, T frtol) {
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
  hmatvec(H, sc, Hsc);
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
  bool solved = chol_solve(Hm, rhs, T(0), d);
  if (!solved) {
    const double kShifts[5] = {1e-10, 1e-6, 1e-3, 1.0, 1e3};
#pragma unroll 1
    for (int lvl = 0; lvl < 5 && !solved; ++lvl) {
      solved = chol_solve(Hm, rhs, dmax * T(kShifts[lvl]), d);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = (free_[i] && solved) ? d[i] : T(0);

  // clip the combined step to the trust region (dtrqsol)
  const T dd = dot6(d, d);
  const T sd = dot6(sc, d);
  const T ss = dot6(sc, sc);
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
  const T q_c = dot6(g, sc) + T(0.5) * dot6(sc, Hsc);
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
    T gd = dot6(gc, diff);
    gd = (gd > T(0)) ? T(0) : gd;
    if (qval(g, H, s_try) <= q_c + T(kMu0) * gd) {
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
  const T ft = branch_obj(xt, ln.p, ln.lam, ln.mu);
  const T predred = -qval(g, H, s);
  const T actred = f - ft;
  const T gts = dot6(g, s);
  const T snorm = dsqrt(dot6(s, s));

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tron_alm_branch_kernel(const T* __restrict__ x0, const T* __restrict__ xl,
                           const T* __restrict__ xu, const T* __restrict__ P,
                           const T* __restrict__ lam0,
                           const T* __restrict__ mu0,
                           const unsigned char* __restrict__ active0,
                           T* __restrict__ x_out, T* __restrict__ lam_out,
                           T* __restrict__ mu_out, int* __restrict__ minor_out,
                           int* __restrict__ alm_out,
                           T* __restrict__ cviol_out, int B, T gtol, T frtol,
                           T ctol, T mu_max, int max_minor, int max_auglag,
                           int step_cap) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;

  Lane<T> ln;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ln.x[i] = x0[i * B + lane];
    ln.xl[i] = xl[i * B + lane];
    ln.xu[i] = xu[i * B + lane];
  }
  ln.lam[0] = lam0[lane];
  ln.lam[1] = lam0[B + lane];
  ln.mu = mu0[lane];
  ln.p.YffR = P[0 * B + lane];
  ln.p.YffI = P[1 * B + lane];
  ln.p.YftR = P[2 * B + lane];
  ln.p.YftI = P[3 * B + lane];
  ln.p.YttR = P[4 * B + lane];
  ln.p.YttI = P[5 * B + lane];
  ln.p.YtfR = P[6 * B + lane];
  ln.p.YtfI = P[7 * B + lane];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    ln.p.l[k] = P[(8 + k) * B + lane];
    ln.p.rho[k] = P[(16 + k) * B + lane];
    ln.p.t[k] = P[(24 + k) * B + lane];
  }
  ln.p.scale = P[32 * B + lane];

  bool active = active0[lane] != 0;
  T f = active ? branch_obj(ln.x, ln.p, ln.lam, ln.mu) : T(0);
  T delta = T(0), alpha_c = T(1);
  int tron_it = 0, alm_it = 0, minor_total = 0;
  bool tron_done = false, need_init = true;
  T eta = T(1) / dpow(ln.mu, T(0.1));
  T cviol = T(INFINITY);

#pragma unroll 1
  for (int steps = 0; steps < step_cap && active; ++steps) {
    T g[N], H[NS];
    branch_gh(ln.x, ln.p, ln.lam, ln.mu, g, H);

    if (need_init) {
      const T gnorm = dsqrt(dot6(g, g));
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
    T c[2];
    branch_cons(ln.x, ln.p, c);
    const T cnorm = tmax(T(fabs(c[0])), T(fabs(c[1])));
    const bool good = cnorm <= eta;
    const bool line_solved = good && (cnorm <= ctol);
    const T lam_old[2] = {ln.lam[0], ln.lam[1]};
    const T mu_old = ln.mu;
    if (good && !line_solved) {
      ln.lam[0] = ln.lam[0] + mu_old * c[0];
      ln.lam[1] = ln.lam[1] + mu_old * c[1];
      eta = eta / dpow(mu_old, T(0.9));
    }
    if (!good) {
      const T m10 = mu_old * T(10);
      ln.mu = (m10 > mu_max) ? mu_max : m10;
      eta = T(1) / dpow(ln.mu, T(0.1));
    }
    ++alm_it;
    if (line_solved || alm_it >= max_auglag) {
      active = false;
    } else {
      tron_done = false;
      tron_it = 0;
      need_init = true;
      // branch_alm_delta: the objective is affine in (lam, mu) at fixed x
      const T dl = (ln.lam[0] - lam_old[0]) * c[0] +
                   (ln.lam[1] - lam_old[1]) * c[1];
      const T dq = T(0.5) * (ln.mu - mu_old) * (c[0] * c[0] + c[1] * c[1]);
      f = f + (dl + dq) * ln.p.scale;
    }
    cviol = cnorm;
  }

#pragma unroll
  for (int i = 0; i < N; ++i) x_out[i * B + lane] = ln.x[i];
  lam_out[lane] = ln.lam[0];
  lam_out[B + lane] = ln.lam[1];
  mu_out[lane] = ln.mu;
  minor_out[lane] = minor_total;
  alm_out[lane] = alm_it;
  cviol_out[lane] = cviol;
}

template <typename T>
int launch(const void* x0, const void* xl, const void* xu, const void* P,
           const void* lam0, const void* mu0, const void* active0, void* x,
           void* lam, void* mu, void* minor, void* alm, void* cviol, int B,
           double gtol, double frtol, double ctol, double mu_max,
           int max_minor, int max_auglag, int step_cap, void* stream) {
  if (B > 0) {
    const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
    tron_alm_branch_kernel<T><<<blocks, kThreads, 0,
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

}  // namespace

extern "C" {

int tron_alm_branch_f64(const void* x0, const void* xl, const void* xu,
                        const void* P, const void* lam0, const void* mu0,
                        const void* active0, void* x, void* lam, void* mu,
                        void* minor, void* alm, void* cviol, int B,
                        double gtol, double frtol, double ctol, double mu_max,
                        int max_minor, int max_auglag, int step_cap,
                        void* stream) {
  return launch<double>(x0, xl, xu, P, lam0, mu0, active0, x, lam, mu, minor,
                        alm, cviol, B, gtol, frtol, ctol, mu_max, max_minor,
                        max_auglag, step_cap, stream);
}

int tron_alm_branch_f32(const void* x0, const void* xl, const void* xu,
                        const void* P, const void* lam0, const void* mu0,
                        const void* active0, void* x, void* lam, void* mu,
                        void* minor, void* alm, void* cviol, int B,
                        double gtol, double frtol, double ctol, double mu_max,
                        int max_minor, int max_auglag, int step_cap,
                        void* stream) {
  return launch<float>(x0, xl, xu, P, lam0, mu0, active0, x, lam, mu, minor,
                       alm, cviol, B, gtol, frtol, ctol, mu_max, max_minor,
                       max_auglag, step_cap, stream);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
