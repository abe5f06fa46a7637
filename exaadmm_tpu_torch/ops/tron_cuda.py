"""The branch TRON/ALM batch: one line subproblem per lane.

Replaces ``exaadmm_tpu/ops/tron_pallas.py::tron_alm_batched_pallas`` for the
ACOPF branch instance (n=6, ncon=2, ``branch_fgh_linelimit``,
``branch_alm_delta``):

- on a CUDA tensor, ``csrc/tron_alm_branch.cu`` runs one thread per line,
  each thread the lane's own loop of the lockstep state machine;
- on a CPU tensor, the plain version ``ops/tron.py::tron_alm_batched`` with
  the branch functions of ``models/acopf/branch.py``.

``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .tron import TronALMResult, tron_alm_batched

launches = 0

_FN = {torch.float64: "tron_alm_branch_f64",
       torch.float32: "tron_alm_branch_f32"}
N_VAR, N_CON, N_PARAM = 6, 2, 33
# (x0, xl, xu, params, lam0, mu0, active0, x, lam, mu, minor, alm, cviol,
#  B, gtol, frtol, ctol, mu_max, max_minor, max_auglag, step_cap, stream)
_SIG = ([ctypes.c_void_p] * 13 + [ctypes.c_int] + [ctypes.c_double] * 4
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def library():
    """The kernel library, built from ``csrc/tron_alm_branch.cu`` at first
    call."""
    return _build.load("tron_alm_branch", {fn: _SIG for fn in _FN.values()})


def pack_params(params: dict) -> torch.Tensor:
    """The kernel's (33, B) parameter block: the 8 admittances in
    ``branch.Y_KEYS`` order, then l (8), rho (8), t (8) and scale."""
    from ..models.acopf.branch import Y_KEYS
    return torch.cat([torch.stack([params[k] for k in Y_KEYS]),
                      params["l"], params["rho"], params["t"],
                      params["scale"][None]]).contiguous()


def tron_alm_branch_plain(x0, xl, xu, params, lam0, mu0, *, active0=None,
                          **opts) -> TronALMResult:
    """The plain PyTorch version, on any device."""
    from ..models.acopf.branch import (branch_alm_delta, branch_cons_linelimit,
                                       branch_fgh_linelimit,
                                       branch_obj_linelimit)
    return tron_alm_batched(
        branch_obj_linelimit, branch_cons_linelimit, branch_fgh_linelimit,
        x0, xl, xu, params, lam0, mu0, active0=active0,
        alm_delta_fn=branch_alm_delta, **opts)


def tron_alm_branch(x0, xl, xu, params, lam0, mu0, *, gtol: float,
                    frtol: float, ctol: float, mu_max: float, max_minor: int,
                    max_auglag: int, step_cap: int | None = None,
                    active0: torch.Tensor | None = None) -> TronALMResult:
    """Solve the B line subproblems; x0/xl/xu (6, B), lam0 (2, B), mu0 (B,),
    params a dict of (B,) admittances and (8, B) l/rho/t plus (B,) scale.
    Lanes with ``active0`` False come back untouched."""
    opts = dict(gtol=gtol, frtol=frtol, ctol=ctol, mu_max=mu_max,
                max_minor=max_minor, max_auglag=max_auglag, step_cap=step_cap)
    if x0.device.type == "cpu":
        return tron_alm_branch_plain(x0, xl, xu, params, lam0, mu0,
                                     active0=active0, **opts)
    if x0.device.type != "cuda":
        raise ValueError(f"tron_alm_branch: unsupported device {x0.device}")
    dtype = x0.dtype
    if dtype not in _FN:
        raise TypeError(f"tron_alm_branch: dtype {dtype} not supported")
    B = x0.shape[1]
    if active0 is None:
        active0 = torch.ones(B, dtype=torch.bool, device=x0.device)
    P = pack_params(params)
    inputs = (("x0", x0, (N_VAR, B)), ("xl", xl, (N_VAR, B)),
              ("xu", xu, (N_VAR, B)), ("params", P, (N_PARAM, B)),
              ("lam0", lam0, (N_CON, B)), ("mu0", mu0, (B,)))
    for name, t, shape in inputs:
        if (t.device != x0.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"tron_alm_branch: {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {x0.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    act = active0.to(torch.uint8).contiguous()
    if act.device != x0.device or tuple(act.shape) != (B,):
        raise ValueError("tron_alm_branch: active0 must be (B,) on the device")

    x = torch.empty_like(x0)
    lam = torch.empty_like(lam0)
    mu = torch.empty_like(mu0)
    minor = torch.empty(B, dtype=torch.int32, device=x0.device)
    alm = torch.empty(B, dtype=torch.int32, device=x0.device)
    cviol = torch.empty_like(mu0)
    cap = max_minor * max_auglag if step_cap is None else step_cap

    global launches
    lib = library()
    # the temporaries (P, act) may be freed on return while the kernel still
    # reads them: the caching allocator reuses their memory only for work
    # queued later on the same stream, so that is safe
    ptrs = [t.data_ptr() for t in
            (x0, xl, xu, P, lam0, mu0, act, x, lam, mu, minor, alm, cviol)]
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _FN[dtype])(
            *ptrs, B, gtol, frtol, ctol, mu_max, max_minor, max_auglag, cap,
            stream)
    _build.check(lib, err, "tron_alm_branch")
    launches += 1
    return TronALMResult(x=x, lam=lam, mu=mu, minor_iters=minor,
                         alm_iters=alm, cviol=cviol)
