// Branch TRON/ALM batch: one 6-variable line subproblem per thread group.
//
// Replaces: exaadmm_tpu/ops/tron_pallas.py::tron_alm_batched_pallas for the
// ACOPF branch instance (n = 6, ncon = 2, branch_fgh_linelimit and
// branch_alm_delta of exaadmm_tpu/models/acopf/branch.py). The plain version
// it is checked against is exaadmm_tpu_torch/ops/tron.py::tron_alm_batched
// with the functions of exaadmm_tpu_torch/models/acopf/branch.py.
//
// The TRON/ALM body, its design and what bounds it are in tron_alm.cuh; the
// problem (shared with the polar instance, tron_alm_polar.cu) is in
// branch_problem.cuh.
//
// C interface (no PyTorch headers): tron_alm_branch_f64/_f32 and
// error_string, each launch returning cudaGetLastError().

#include "branch_problem.cuh"

namespace {

template <typename T>
using LineLimitProblem = BranchProblem<T, true>;

}  // namespace

TRON_ALM_ENTRY_POINTS(tron_alm_branch, LineLimitProblem)
