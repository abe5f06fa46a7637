// Polar TRON batch: one 4-variable line subproblem without line limits per
// thread group.
//
// Replaces: exaadmm_tpu/models/acopf/branch.py::branch_update's path without
// line limits, which runs tron_batched (exaadmm_tpu/ops/tron.py, the body of
// tron_alm_batched with no constraints) over branch_obj_polar as plain XLA:
// the JAX package has no Pallas kernel for it. The plain version it is
// checked against is exaadmm_tpu_torch/ops/tron.py::tron_alm_batched with
// branch_obj_polar / branch_fgh_polar of
// exaadmm_tpu_torch/models/acopf/branch.py.
//
// The TRON/ALM body, its design and what bounds it are in tron_alm.cuh; the
// problem is the branch instance's without line limits
// (branch_problem.cuh): x = (v_i, v_j, th_i, th_j), the same 33 parameters,
// no constraints (NCON = 0: the single ALM round finds ||c|| = 0 and ends
// the lane).
//
// C interface (no PyTorch headers): tron_alm_polar_f64/_f32 and
// error_string, each launch returning cudaGetLastError().

#include "branch_problem.cuh"

namespace {

template <typename T>
using PolarProblem = BranchProblem<T, false>;

}  // namespace

TRON_ALM_ENTRY_POINTS(tron_alm_polar, PolarProblem)
