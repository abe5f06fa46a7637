"""exaadmm_tpu_torch: the two-level ADMM ACOPF solver in PyTorch and CUDA.

The port of ``exaadmm_tpu`` (JAX) to PyTorch with hand-written kernels for an
NVIDIA H100 (``sm_90a``). It mirrors the JAX package's module names; inside,
state is plain dataclasses of tensors (with ``replace`` and ``to``), the
updates are plain functions on tensors, every tensor lives on an explicit
``device``, and the default dtype is ``torch.float64``.

Nothing here is trained, so there is no ``nn.Module`` and no
``torch.autograd.Function``. The two kernels of the main path are built from
``csrc/`` at first use on a CUDA tensor; on a CPU tensor each wrapper runs
its plain PyTorch version:

- ``ops/tron_cuda.py``: the branch TRON/ALM batch (``csrc/tron_alm_branch.cu``),
- ``ops/bus_cuda.py``: the deterministic bus scatter (``csrc/bus_scatter.cu``).

This package imports neither jax nor ``exaadmm_tpu``.
"""

from .interface.solve_acopf import SolveResult, solve_acopf
from .utils.environment import Blocks, Parameters, Solution
from .utils.opfdata import opf_loaddata

__version__ = "0.1.0"

__all__ = [
    "solve_acopf",
    "SolveResult",
    "Parameters",
    "Solution",
    "Blocks",
    "opf_loaddata",
]
