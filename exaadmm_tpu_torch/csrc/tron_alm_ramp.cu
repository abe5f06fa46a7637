// Ramp TRON/ALM batch: one 3-variable generator subproblem of the
// multi-period model per thread group.
//
// Replaces: exaadmm_tpu/ops/tron_pallas.py::tron_alm_batched_pallas for the
// multi-period ramp instance (exaadmm_tpu/models/mpacopf/model.py
// _ramp_alm_update: n = 3, ncon = 1, gen_obj / gen_cons, the objective
// evaluated afresh after each ALM round). The plain version it is checked
// against is exaadmm_tpu_torch/ops/tron.py::tron_alm_batched with the
// functions of exaadmm_tpu_torch/models/mpacopf/ramp.py.
//
// A lane is one (period t >= 2, generator) pair, x = (p_t, phat_{t-1}, s_t)
// with the equality p_t - phat_{t-1} - s_t = 0. The TRON/ALM body, its
// design and what bounds it are in tron_alm.cuh; this file supplies the
// problem, whose gradient and Hessian are closed form: with kap = lam + mu c
// and v = (1, -1, -1), H = diag(2 c2 B^2 + rho_p, rho_h, 0) + mu v v^T.
// The lane state is small: 3-vectors and 3x3 matrices; the 9 parameters
// live once per lane in the body's shared memory.
//
// C interface (no PyTorch headers): tron_alm_ramp_f64/_f32 and
// error_string, each launch returning cudaGetLastError().

#include "tron_alm.cuh"

namespace {

using tron_alm::sym;

// one (period, generator) lane: the 9 rows of the packed parameter block,
// in ramp.PARAM_KEYS order
template <typename T>
struct RampProblem : tron_alm::LaneParams<T> {
  using Real = T;
  static constexpr int N = 3, NCON = 1, NPARAM = 9;
  static constexpr bool kExactAlmDelta = false;

  __device__ __forceinline__ T c2() const { return this->at(0); }
  __device__ __forceinline__ T c1() const { return this->at(1); }
  __device__ __forceinline__ T lam_p() const { return this->at(2); }
  __device__ __forceinline__ T rho_p() const { return this->at(3); }
  __device__ __forceinline__ T t_p() const { return this->at(4); }
  __device__ __forceinline__ T lam_h() const { return this->at(5); }
  __device__ __forceinline__ T rho_h() const { return this->at(6); }
  __device__ __forceinline__ T t_h() const { return this->at(7); }
  __device__ __forceinline__ T base() const { return this->at(8); }

  // ramp_obj: the full ALM objective
  __device__ __forceinline__ T obj(const T* x, const T* lam, T mu) const {
    const T pB = x[0] * base();
    const T dp = x[0] - t_p();
    const T dh = x[1] - t_h();
    T f = c2() * (pB * pB) + c1() * pB;
    f = f + lam_p() * dp + T(0.5) * rho_p() * (dp * dp);
    f = f + lam_h() * dh + T(0.5) * rho_h() * (dh * dh);
    const T c = x[0] - x[1] - x[2];
    return f + lam[0] * c + T(0.5) * mu * (c * c);
  }

  __device__ __forceinline__ void cons(const T* x, T* c) const {
    c[0] = x[0] - x[1] - x[2];
  }

  // ramp_fgh without f: gradient g, and thread r's rows of the Hessian
  __device__ __forceinline__ void gh(const T* x, const T* lam, T mu, T* g,
                                     T (*Hr)[N], int r) const {
    const T c = x[0] - x[1] - x[2];
    const T kap = lam[0] + mu * c;
    const T b = base();
    const T cB2 = T(2) * c2() * b * b;
    g[0] = cB2 * x[0] + c1() * b + lam_p() + rho_p() * (x[0] - t_p()) + kap;
    g[1] = lam_h() + rho_h() * (x[1] - t_h()) - kap;
    g[2] = -kap;
    T H[N * (N + 1) / 2];
    H[sym(0, 0)] = cB2 + rho_p() + mu;
    H[sym(0, 1)] = -mu;
    H[sym(0, 2)] = -mu;
    H[sym(1, 1)] = rho_h() + mu;
    H[sym(1, 2)] = mu;
    H[sym(2, 2)] = mu;
    tron_alm::own_rows<N>(H, r, Hr);
  }
};

}  // namespace

TRON_ALM_ENTRY_POINTS(tron_alm_ramp, RampProblem)
