// Branch TRON/ALM batch: one 6-variable line subproblem per thread group.
//
// Replaces: exaadmm_tpu/ops/tron_pallas.py::tron_alm_batched_pallas for the
// ACOPF branch instance (n = 6, ncon = 2, branch_fgh_linelimit and
// branch_alm_delta of exaadmm_tpu/models/acopf/branch.py). The plain version
// it is checked against is exaadmm_tpu_torch/ops/tron.py::tron_alm_batched
// with the functions of exaadmm_tpu_torch/models/acopf/branch.py.
//
// The TRON/ALM body, its design and what bounds it are in tron_alm.cuh;
// this file supplies the problem. Its 33 parameters live once per lane in
// the body's shared memory; obj, cons and gh read them where they need
// them. gh forms the whole gradient and Hessian on every thread of the
// group (its entries follow different formulas, which would split the warp
// if each thread took its own), and each thread keeps its own rows.
//
// C interface (no PyTorch headers): tron_alm_branch_f64/_f32 and
// error_string, each launch returning cudaGetLastError().

#include "tron_alm.cuh"

namespace {

using tron_alm::dsincos;
using tron_alm::sym;

// structural nonzeros of the flow coefficient rows K[m][b]: column 0 is
// (YffR, -YffI, 0, 0), column 1 is (0, 0, YttR, -YttI), columns 2 and 3 full
__host__ __device__ constexpr bool knz(int m, int b) {
  return b == 0 ? m < 2 : (b == 1 ? m >= 2 : true);
}

// one line: the 33 rows of the packed parameter block, 8 admittances in
// branch.Y_KEYS order, then l (8), rho (8), t (8) and scale
template <typename T>
struct BranchProblem : tron_alm::LaneParams<T> {
  using Real = T;
  static constexpr int N = 6, NCON = 2, NPARAM = 33;
  static constexpr bool kExactAlmDelta = true;
  static constexpr int kL = 8, kRho = 16, kT = 24, kScale = 32;

  // sin and cos of the last angle difference: gh and cons at a point where
  // obj or gh was just evaluated (after an accepted step, or at an
  // unchanged x) reuse them, matched on the angle's bits
  T trig_v = T(0), trig_s = T(0), trig_c = T(0);
  bool trig_ok = false;

  __device__ __forceinline__ static bool same_bits(double a, double b) {
    return __double_as_longlong(a) == __double_as_longlong(b);
  }
  __device__ __forceinline__ static bool same_bits(float a, float b) {
    return __float_as_int(a) == __float_as_int(b);
  }
  __device__ __forceinline__ void angle(T v, T& s, T& c) {
    if (!(trig_ok && same_bits(v, trig_v))) {
      dsincos(v, &trig_s, &trig_c);
      trig_v = v;
      trig_ok = true;
    }
    s = trig_s;
    c = trig_c;
  }

  __device__ __forceinline__ void flows(const T* x, T& pij, T& qij, T& pji,
                                        T& qji) {
    const T YffR = this->at(0), YffI = this->at(1), YftR = this->at(2),
            YftI = this->at(3), YttR = this->at(4), YttI = this->at(5),
            YtfR = this->at(6), YtfI = this->at(7);
    const T vi = x[0], vj = x[1];
    T sin_ij, cos_ij;
    angle(x[2] - x[3], sin_ij, cos_ij);
    const T vv_cos = vi * vj * cos_ij;
    const T vv_sin = vi * vj * sin_ij;
    const T vi2 = vi * vi;
    const T vj2 = vj * vj;
    pij = YffR * vi2 + YftR * vv_cos + YftI * vv_sin;
    qij = (-YffI) * vi2 - YftI * vv_cos + YftR * vv_sin;
    pji = YttR * vj2 + YtfR * vv_cos - YtfI * vv_sin;
    qji = (-YttI) * vj2 - YtfI * vv_cos - YtfR * vv_sin;
  }

  // branch_obj_linelimit: the full ALM objective times scale
  __device__ __forceinline__ T obj(const T* x, const T* lam, T mu) {
    T pij, qij, pji, qji;
    flows(x, pij, qij, pji, qji);
    const T w[8] = {pij, qij, pji, qji, x[0] * x[0], x[1] * x[1], x[2], x[3]};
    T f = T(0);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const T dw = w[k] - this->at(kT + k);
      f = f + this->at(kL + k) * w[k] +
          T(0.5) * this->at(kRho + k) * (dw * dw);
    }
    const T c1 = pij * pij + qij * qij + x[4];
    const T c2 = pji * pji + qji * qji + x[5];
    f = f + lam[0] * c1 + lam[1] * c2 + T(0.5) * mu * (c1 * c1 + c2 * c2);
    return f * this->at(kScale);
  }

  __device__ __forceinline__ void cons(const T* x, T* c) {
    T pij, qij, pji, qji;
    flows(x, pij, qij, pji, qji);
    c[0] = pij * pij + qij * qij + x[4];
    c[1] = pji * pji + qji * qji + x[5];
  }

  // branch_alm_delta: the objective is affine in (lam, mu) at fixed x
  __device__ __forceinline__ T alm_delta(const T* c, const T* lam_old,
                                         T mu_old, const T* lam_new,
                                         T mu_new) const {
    const T dl = (lam_new[0] - lam_old[0]) * c[0] +
                 (lam_new[1] - lam_old[1]) * c[1];
    const T dq = T(0.5) * (mu_new - mu_old) * (c[0] * c[0] + c[1] * c[1]);
    return (dl + dq) * this->at(kScale);
  }

  // branch_fgh_linelimit without f: gradient g, and thread r's rows of the
  // Hessian
  __device__ __forceinline__ void gh(const T* x, const T* lam, T mu, T* g,
                                     T (*Hr)[N], int r) {
    const T YffR = this->at(0), YffI = this->at(1), YftR = this->at(2),
            YftI = this->at(3), YttR = this->at(4), YttI = this->at(5),
            YtfR = this->at(6), YtfI = this->at(7);
    T l[8], rho[8], t[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      l[k] = this->at(kL + k);
      rho[k] = this->at(kRho + k);
      t[k] = this->at(kT + k);
    }
    const T scale = this->at(kScale);
    const T vi = x[0], vj = x[1], ti = x[2], tj = x[3], s1 = x[4], s2 = x[5];
    T s_, c_;
    angle(ti - tj, s_, c_);
    const T u1 = vi * vi, u2 = vj * vj;
    const T u3 = vi * vj * c_;
    const T u4 = vi * vj * s_;

    // flow coefficient rows K_m over the basis (u1, u2, u3, u4); knz marks
    // the structural nonzeros, the only terms of every sum below
    const T K[4][4] = {{YffR, T(0), YftR, YftI},
                       {-YffI, T(0), -YftI, YftR},
                       {T(0), YttR, YtfR, -YtfI},
                       {T(0), -YttI, -YtfI, -YtfR}};
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
    const T gF[4] = {l[0] + rho[0] * (F[0] - t[0]) + T(2) * kap1 * F[0],
                     l[1] + rho[1] * (F[1] - t[1]) + T(2) * kap1 * F[1],
                     l[2] + rho[2] * (F[2] - t[2]) + T(2) * kap2 * F[2],
                     l[3] + rho[3] * (F[3] - t[3]) + T(2) * kap2 * F[3]};
    const T h_u1 = l[4] + rho[4] * (u1 - t[4]);
    const T h_u2 = l[5] + rho[5] * (u2 - t[5]);
    const T h_ti = l[6] + rho[6] * (ti - t[6]);
    const T h_tj = l[7] + rho[7] * (tj - t[7]);

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

    g[0] = (T(2) * vi * a[0] + vj * c_ * a[2] + vj * s_ * a[3]) * scale;
    g[1] = (T(2) * vj * a[1] + vi * c_ * a[2] + vi * s_ * a[3]) * scale;
    g[2] = ((-u4) * a[2] + u3 * a[3] + h_ti) * scale;
    g[3] = (u4 * a[2] - u3 * a[3] + h_tj) * scale;
    g[4] = kap1 * scale;
    g[5] = kap2 * scale;

    // M over the basis: K^T diag(rho_m + 2 kap_blk) K
    //                   + mu (K^T w1)(K^T w1)^T + mu (K^T w2)(K^T w2)^T
    //                   + diag(rho4, rho5, 0, 0)
    const T rt[4] = {rho[0] + T(2) * kap1, rho[1] + T(2) * kap1,
                     rho[2] + T(2) * kap2, rho[3] + T(2) * kap2};
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
    M[0][0] = M[0][0] + rho[4];
    M[1][1] = M[1][1] + rho[5];

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
    H4[2][2] = H4[2][2] - a[2] * u3 - a[3] * u4 + rho[6];
    H4[2][3] = H4[2][3] + a[2] * u3 + a[3] * u4;
    H4[3][3] = H4[3][3] - a[2] * u3 - a[3] * u4 + rho[7];

    // cross terms with the slacks: d kap_blk / dx = mu * Ju^T kw_blk
    const T cross1[4] = {mu * (jv0 * kw1[0] + jc0 * kw1[2] + js0 * kw1[3]),
                         mu * (jv1 * kw1[1] + jc1 * kw1[2] + js1 * kw1[3]),
                         mu * ((-u4) * kw1[2] + u3 * kw1[3]),
                         mu * (u4 * kw1[2] + (-u3) * kw1[3])};
    const T cross2[4] = {mu * (jv0 * kw2[0] + jc0 * kw2[2] + js0 * kw2[3]),
                         mu * (jv1 * kw2[1] + jc1 * kw2[2] + js1 * kw2[3]),
                         mu * ((-u4) * kw2[2] + u3 * kw2[3]),
                         mu * (u4 * kw2[2] + (-u3) * kw2[3])};

    T H[N * (N + 1) / 2];
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
    tron_alm::own_rows<N>(H, r, Hr);
  }
};

}  // namespace

TRON_ALM_ENTRY_POINTS(tron_alm_branch, BranchProblem)
