"""Standalone Newton-Raphson power flow (reference solve_pf.jl).

Counterpart of ``exaadmm_tpu/interface/solve_pf.py``; it runs on the host
with numpy and scipy, as in the JAX package."""

from ..models.pf.newton import PowerFlowResult, solve_pf  # noqa: F401
