// QP-subproblem TRON/ALM batch: one reduced 6-variable line QP per thread.
//
// Replaces: exaadmm_tpu/ops/tron_pallas.py::tron_alm_batched_pallas for the
// QP-subproblem instance (exaadmm_tpu/models/qpsub/model.py update_x: n = 6,
// ncon = 2, the closed-form _reduced_qp_fns and branch_alm_delta). The plain
// version it is checked against is exaadmm_tpu_torch/ops/tron.py::
// tron_alm_batched with qp_obj / qp_cons / qp_fgh of
// exaadmm_tpu_torch/models/qpsub/model.py.
//
// A lane is one line, x = (t_ij, t_ji, w_i, w_j, th_i, th_j). Its objective
// is the quadratic 1/2 x'Gx + h0'x + fc and its two constraints are affine,
// c3 = w3'x + e3 and c4 = w4'x + e4, so with kap = lam + mu c
//   g = (Gx + h0 + kap3 w3 + kap4 w4) scale,
//   H = (G + mu (w3 w3' + w4 w4')) scale.
// G is exactly symmetric (the model mirrors its lower triangle), so the
// packed Hessian of tron_alm.cuh holds the same matrix the plain version
// reads in full. Every sum runs in index order, as in the plain version.
//
// What bounds it: registers. A lane has 43 parameters (21 of G's lower
// triangle, h0, w3, w4, fc, e3, e4, scale); held beside the lane state, the
// TRON temporaries and the Cholesky factor they would not fit in fp64. So
// the problem struct keeps only the block pointer, the lane and B, and
// obj / cons / gh read the parameters from global memory when they need
// them. The block is (43, B) rows, so a warp's reads of one row are
// contiguous, and a lane's 43 values stay in L1/L2 between reads.
//
// C interface (no PyTorch headers): tron_alm_qpsub_f64/_f32 and
// error_string, each launch returning cudaGetLastError().

#include "tron_alm.cuh"

namespace {

using tron_alm::sym;

// parameter rows: G's lower triangle at sym(i, j), then h0, w3, w4 (6 rows
// each), then fc, e3, e4, scale
constexpr int kH0 = 21, kW3 = 27, kW4 = 33, kFc = 39, kE3 = 40, kE4 = 41,
              kScale = 42;

template <typename T>
struct QpsubProblem {
  using Real = T;
  static constexpr int N = 6, NCON = 2, NPARAM = 43;
  static constexpr bool kExactAlmDelta = true;

  const T* P;
  int lane, B;

  __device__ __forceinline__ void load(const T* P_, int lane_, int B_) {
    P = P_;
    lane = lane_;
    B = B_;
  }

  __device__ __forceinline__ T at(int row) const {
    return __ldg(P + static_cast<size_t>(row) * B + lane);
  }

  // Gx_i = G[i][0] x[0] + G[i][1] x[1] + ... in column order
  __device__ __forceinline__ void gx(const T* x, T* out) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T acc = at(sym(i, 0)) * x[0];
#pragma unroll
      for (int j = 1; j < N; ++j) acc = acc + at(sym(i, j)) * x[j];
      out[i] = acc;
    }
  }

  // c3 = w3'x + e3, c4 = w4'x + e4
  __device__ __forceinline__ void cons(const T* x, T* c) const {
    T a3 = at(kW3) * x[0];
    T a4 = at(kW4) * x[0];
#pragma unroll
    for (int i = 1; i < N; ++i) {
      a3 = a3 + at(kW3 + i) * x[i];
      a4 = a4 + at(kW4 + i) * x[i];
    }
    c[0] = a3 + at(kE3);
    c[1] = a4 + at(kE4);
  }

  // qp_obj: the full ALM objective times scale
  __device__ __forceinline__ T obj(const T* x, const T* lam, T mu) const {
    T c[2];
    cons(x, c);
    T Gx[N];
    gx(x, Gx);
    T f = (T(0.5) * Gx[0] + at(kH0)) * x[0];
#pragma unroll
    for (int i = 1; i < N; ++i) f = f + (T(0.5) * Gx[i] + at(kH0 + i)) * x[i];
    f = f + at(kFc) + lam[0] * c[0] + lam[1] * c[1] +
        T(0.5) * mu * (c[0] * c[0] + c[1] * c[1]);
    return f * at(kScale);
  }

  // branch_alm_delta: the objective is affine in (lam, mu) at fixed x
  __device__ __forceinline__ T alm_delta(const T* c, const T* lam_old,
                                         T mu_old, const T* lam_new,
                                         T mu_new) const {
    const T dl = (lam_new[0] - lam_old[0]) * c[0] +
                 (lam_new[1] - lam_old[1]) * c[1];
    const T dq = T(0.5) * (mu_new - mu_old) * (c[0] * c[0] + c[1] * c[1]);
    return (dl + dq) * at(kScale);
  }

  // qp_fgh without f: gradient g and packed Hessian H
  __device__ __forceinline__ void gh(const T* x, const T* lam, T mu, T* g,
                                     T* H) const {
    T c[2];
    cons(x, c);
    const T kap3 = lam[0] + mu * c[0];
    const T kap4 = lam[1] + mu * c[1];
    const T scale = at(kScale);
    T Gx[N];
    gx(x, Gx);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T w3i = at(kW3 + i), w4i = at(kW4 + i);
      g[i] = (Gx[i] + at(kH0 + i) + kap3 * w3i + kap4 * w4i) * scale;
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        H[sym(i, j)] =
            (at(sym(i, j)) + mu * (w3i * at(kW3 + j) + w4i * at(kW4 + j))) *
            scale;
      }
    }
  }
};

}  // namespace

TRON_ALM_ENTRY_POINTS(tron_alm_qpsub, QpsubProblem)
