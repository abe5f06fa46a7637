"""Standalone Newton-Raphson power flow (reference solve_pf.jl).

Counterpart of ``exaadmm_tpu/interface/solve_pf.py``; it runs on the host
with numpy and scipy, as in the JAX package."""

from ..models.pf import newton
from ..models.pf.newton import PowerFlowResult  # noqa: F401
from ..utils import tracing

solve_pf = tracing.spanned("entry.solve", entry="solve_pf")(newton.solve_pf)
