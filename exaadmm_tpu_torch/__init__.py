"""exaadmm_tpu_torch: the ADMM ACOPF solvers in PyTorch and CUDA.

The port of ``exaadmm_tpu`` (JAX) to PyTorch with hand-written kernels for an
NVIDIA H100 (``sm_90a``). It mirrors the JAX package's module names; inside,
state is plain dataclasses of tensors (with ``replace`` and ``to``), the
updates are plain functions on tensors, every tensor lives on an explicit
``device``, and the default dtype is ``torch.float64``.

Nothing here is trained, so there is no ``nn.Module`` and no
``torch.autograd.Function``. The kernels are built from ``csrc/`` at first
use on a CUDA tensor; on a CPU tensor each wrapper runs its plain PyTorch
version:

- ``ops/tron_cuda.py``: the TRON/ALM batches, one body
  (``csrc/tron_alm.cuh``) for the branch instance
  (``csrc/tron_alm_branch.cu``), the branch without line limits
  (``csrc/tron_alm_polar.cu``), the multi-period ramp instance
  (``csrc/tron_alm_ramp.cu``) and the QP-subproblem instance
  (``csrc/tron_alm_qpsub.cu``),
- ``ops/bus_cuda.py``: the deterministic bus scatter (``csrc/bus_scatter.cu``).

Entry points: ``solve_acopf`` (single period, with or without line limits
and the power-flow projection; ``solve_acopf_from_env`` re-runs one),
``solve_acopf_rolling`` (period after period, ramp-tightened),
``solve_mpacopf`` (periods coupled by generator ramping) and
``solve_acopf_mpec`` (voltage/frequency control and storage) on the
two-level ADMM; ``solve_qpsub`` (the QP subproblem of an outer SQP) on the
one-level ADMM; ``solve_pf`` (Newton power flow, on the host with numpy
and scipy). ``python -m exaadmm_tpu_torch <case.m>`` runs them from the
command line (``__main__.py``).

Around them: ``save_solution`` / ``load_solution`` (``utils/checkpoint.py``)
write and read any solver state in the JAX package's ``.npz`` format, for
resuming a solve; ``utils/profiling.py`` times the ADMM hooks and writes
profiler traces; ``parallel/`` splits the lines across the ranks of a
``torch.distributed`` run, one process per GPU (the ``mesh`` argument of
``solve_acopf``, ``solve_qpsub`` and ``solve_acopf_mpec``, ``--mesh N`` on
the command line); ``AdmmEnv`` records what a solve was asked to do.

Tracing (``utils/tracing.py``) is off by default and costs one flag test a
site while off. ``tracing.enable()`` turns it on; ``tracing.take()`` then
returns the spans recorded since the last call, on ``time.time_ns()``'s
clock, which ``torch.profiler`` shares: each entry point, model build and
initial point, and each fused solve with its phases (build, input copies,
reset, launch, clone, read-back), the solve carrying its counts,
``time_overall``, the device seconds of its loop graph (CUDA events) and
the line batch's TRON steps. Under a recording profiler the spans also
show as profiler ranges.

This package imports neither jax nor ``exaadmm_tpu``.
"""

from .interface.solve_acopf import (SolveResult, solve_acopf,
                                    solve_acopf_from_env)
from .interface.solve_acopf_rolling import solve_acopf_rolling
from .interface.solve_mpacopf import MpacopfResult, solve_mpacopf
from .interface.solve_mpec import MpecResult, solve_acopf_mpec
from .interface.solve_pf import solve_pf
from .interface.solve_qpsub import QpsubResult, solve_qpsub
from .utils.checkpoint import load_solution, save_solution
from .utils.environment import AdmmEnv, Blocks, Parameters, Solution
from .utils.opfdata import opf_loaddata

__version__ = "0.1.0"

__all__ = [
    "solve_acopf",
    "SolveResult",
    "solve_acopf_from_env",
    "solve_acopf_rolling",
    "solve_mpacopf",
    "MpacopfResult",
    "solve_acopf_mpec",
    "MpecResult",
    "solve_qpsub",
    "QpsubResult",
    "solve_pf",
    "AdmmEnv",
    "save_solution",
    "load_solution",
    "Parameters",
    "Solution",
    "Blocks",
    "opf_loaddata",
]
