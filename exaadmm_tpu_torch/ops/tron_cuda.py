"""The TRON/ALM batches: one small subproblem per lane.

Replaces ``exaadmm_tpu/ops/tron_pallas.py::tron_alm_batched_pallas`` for
three problem instances, and ``tron_batched`` (plain XLA in the JAX package)
for a fourth; all four share one CUDA body (``csrc/tron_alm.cuh``):

- the ACOPF branch (n=6, ncon=2, ``branch_fgh_linelimit``,
  ``branch_alm_delta``): ``tron_alm_branch``, ``csrc/tron_alm_branch.cu``;
- the multi-period ramp generator (n=3, ncon=1, ``ramp_fgh``, the objective
  evaluated afresh after each ALM round): ``tron_alm_ramp``,
  ``csrc/tron_alm_ramp.cu``;
- the QP subproblem (n=6, ncon=2, the reduced QP's closed-form ``qp_fgh``
  of ``models/qpsub/model.py``, ``branch_alm_delta``): ``tron_alm_qpsub``,
  ``csrc/tron_alm_qpsub.cu``;
- the ACOPF branch without line limits (n=4, ncon=0, ``branch_fgh_polar``;
  one ALM round that finds no constraint): ``tron_alm_polar``,
  ``csrc/tron_alm_polar.cu``.

On a CUDA tensor a wrapper runs its kernel, one group of threads per lane
(``tron_alm::kGroup``), each group the lane's own loop of the lockstep state
machine; on a CPU tensor it runs the plain version
``ops/tron.py::tron_alm_batched`` with the instance's functions; any other
device raises.

``tron_alm_packed`` launches the branch or polar instance on a parameter
block that is already packed (``ops/branch_cuda.branch_pack`` writes it),
as ``branch_update`` does; the dict entry points pack it themselves.

``launches`` counts the kernels' launches by entry point
(``tron_alm_branch_f64``, ``tron_alm_branch_f32`` and so on, so the f32
instances of a mixed-precision solve show apart from the f64 ones), a
launch that a fused driver's graph replays once per replay
(``graph_loop.count_launch``); ``instance_launches`` sums an instance's
two.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build, graph_loop
from .tron import TronALMResult, tron_alm_batched

launches: dict = {}

# (x0, xl, xu, params, lam0, mu0, active0, x, lam, mu, minor, alm, cviol,
#  B, gtol, frtol, ctol, mu_max, max_minor, max_auglag, step_cap, stream)
_SIG = ([ctypes.c_void_p] * 13 + [ctypes.c_int] + [ctypes.c_double] * 4
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])


class _Instance(NamedTuple):
    name: str      # csrc/<name>.cu, entry points <name>_f64 / <name>_f32
    n: int
    ncon: int
    nparam: int


BRANCH = _Instance("tron_alm_branch", 6, 2, 33)
RAMP = _Instance("tron_alm_ramp", 3, 1, 9)
# the lower triangle of G (21), h0, w3, w4 (6 each), fc, e3, e4, scale
QPSUB = _Instance("tron_alm_qpsub", 6, 2, 21 + 3 * 6 + 4)
# the branch's parameter block (pack_params); no constraints
POLAR = _Instance("tron_alm_polar", 4, 0, 33)
_SUFFIX = {torch.float64: "_f64", torch.float32: "_f32"}


def _add_launches(entry: str, n: int) -> None:
    launches[entry] = launches.get(entry, 0) + n


def instance_launches(inst: _Instance) -> int:
    """The launches of an instance's kernel, f64 and f32 together."""
    return sum(launches.get(inst.name + sfx, 0) for sfx in _SUFFIX.values())


def library(inst: _Instance):
    """The instance's kernel library, built from ``csrc/<name>.cu`` at first
    call."""
    return _build.load(inst.name,
                       {inst.name + sfx: _SIG for sfx in _SUFFIX.values()})


def pack_params(params: dict) -> torch.Tensor:
    """The branch kernel's (33, B) parameter block: the 8 admittances in
    ``branch.Y_KEYS`` order, then l (8), rho (8), t (8) and scale."""
    from ..models.acopf.branch import Y_KEYS
    return torch.cat([torch.stack([params[k] for k in Y_KEYS]),
                      params["l"], params["rho"], params["t"],
                      params["scale"][None]]).contiguous()


def params_view(P: torch.Tensor) -> dict:
    """The params dict of a packed (33, B) branch block (``pack_params``'
    rows), as views of it."""
    from ..models.acopf.branch import Y_KEYS
    p = {k: P[i] for i, k in enumerate(Y_KEYS)}
    p.update(l=P[8:16], rho=P[16:24], t=P[24:32], scale=P[32])
    return p


def pack_ramp_params(params: dict) -> torch.Tensor:
    """The ramp kernel's (9, B) parameter block, rows in
    ``ramp.PARAM_KEYS`` order."""
    from ..models.mpacopf.ramp import PARAM_KEYS
    return torch.stack([params[k] for k in PARAM_KEYS]).contiguous()


def pack_qpsub_params(params: dict) -> torch.Tensor:
    """The QP-subproblem kernel's (43, B) parameter block: G's lower
    triangle row by row (entry (i, j), j <= i, at row i (i + 1) / 2 + j),
    then the rows of h0, w3 and w4, then fc, e3, e4 and scale."""
    G = params["G"]
    rows = [G[i, j] for i in range(6) for j in range(i + 1)]
    for k in ("h0", "w3", "w4"):
        rows.extend(params[k].unbind(0))
    rows.extend(params[k] for k in ("fc", "e3", "e4", "scale"))
    return torch.stack(rows)


def tron_alm_branch_plain(x0, xl, xu, params, lam0, mu0, *, active0=None,
                          **opts) -> TronALMResult:
    """The plain PyTorch version of the branch batch, on any device."""
    from ..models.acopf.branch import (branch_alm_delta, branch_cons_linelimit,
                                       branch_fgh_linelimit,
                                       branch_obj_linelimit)
    return tron_alm_batched(
        branch_obj_linelimit, branch_cons_linelimit, branch_fgh_linelimit,
        x0, xl, xu, params, lam0, mu0, active0=active0,
        alm_delta_fn=branch_alm_delta, **opts)


def tron_alm_ramp_plain(x0, xl, xu, params, lam0, mu0, *, active0=None,
                        **opts) -> TronALMResult:
    """The plain PyTorch version of the ramp batch, on any device."""
    from ..models.mpacopf.ramp import ramp_cons, ramp_fgh, ramp_obj
    return tron_alm_batched(ramp_obj, ramp_cons, ramp_fgh, x0, xl, xu,
                            params, lam0, mu0, active0=active0,
                            alm_delta_fn=None, **opts)


def tron_alm_qpsub_plain(x0, xl, xu, params, lam0, mu0, *, active0=None,
                         **opts) -> TronALMResult:
    """The plain PyTorch version of the QP-subproblem batch, on any
    device; the objective is affine in (lam, mu) as the branch problem's,
    so its ALM delta is ``branch_alm_delta``."""
    from ..models.acopf.branch import branch_alm_delta
    from ..models.qpsub.model import qp_cons, qp_fgh, qp_obj
    return tron_alm_batched(qp_obj, qp_cons, qp_fgh, x0, xl, xu, params,
                            lam0, mu0, active0=active0,
                            alm_delta_fn=branch_alm_delta, **opts)


def tron_alm_polar_plain(x0, xl, xu, params, lam0, mu0, *, active0=None,
                         **opts) -> TronALMResult:
    """The plain PyTorch version of the polar batch, on any device."""
    from ..models.acopf.branch import (branch_cons_polar, branch_fgh_polar,
                                       branch_obj_polar)

    def obj(x, p, lam, mu):
        return branch_obj_polar(x, p)

    return tron_alm_batched(obj, branch_cons_polar, branch_fgh_polar, x0, xl,
                            xu, params, lam0, mu0, active0=active0,
                            alm_delta_fn=None, **opts)


def _launch(inst: _Instance, x0, xl, xu, P, lam0, mu0, active0, gtol, frtol,
            ctol, mu_max, max_minor, max_auglag, step_cap) -> TronALMResult:
    """Check the inputs of a CUDA batch and launch the instance's kernel."""
    dtype = x0.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"{inst.name}: dtype {dtype} not supported")
    B = x0.shape[1]
    if active0 is None:
        active0 = torch.ones(B, dtype=torch.bool, device=x0.device)
    inputs = (("x0", x0, (inst.n, B)), ("xl", xl, (inst.n, B)),
              ("xu", xu, (inst.n, B)), ("params", P, (inst.nparam, B)),
              ("lam0", lam0, (inst.ncon, B)), ("mu0", mu0, (B,)))
    for name, t, shape in inputs:
        if (t.device != x0.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{inst.name}: {name} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {x0.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    act = active0.to(torch.uint8).contiguous()
    if act.device != x0.device or tuple(act.shape) != (B,):
        raise ValueError(f"{inst.name}: active0 must be (B,) on the device")

    x = torch.empty_like(x0)
    lam = torch.empty_like(lam0)
    mu = torch.empty_like(mu0)
    minor = torch.empty(B, dtype=torch.int32, device=x0.device)
    alm = torch.empty(B, dtype=torch.int32, device=x0.device)
    cviol = torch.empty_like(mu0)
    cap = max_minor * max_auglag if step_cap is None else step_cap

    lib = library(inst)
    entry = inst.name + _SUFFIX[dtype]
    # the temporaries (P, act) may be freed on return while the kernel still
    # reads them: the caching allocator reuses their memory only for work
    # queued later on the same stream, so that is safe
    ptrs = [t.data_ptr() for t in
            (x0, xl, xu, P, lam0, mu0, act, x, lam, mu, minor, alm, cviol)]
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            *ptrs, B, gtol, frtol, ctol, mu_max, max_minor, max_auglag, cap,
            stream)
    _build.check(lib, err, inst.name)
    if B > 0:   # an empty batch launches no kernel
        graph_loop.count_launch(lambda n: _add_launches(entry, n), entry)
    return TronALMResult(x=x, lam=lam, mu=mu, minor_iters=minor,
                         alm_iters=alm, cviol=cviol)


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
    return _launch(BRANCH, x0, xl, xu, pack_params(params), lam0, mu0,
                   active0, **opts)


def tron_alm_packed(inst: _Instance, x0, xl, xu, P, lam0, mu0, *,
                    active0: torch.Tensor, gtol: float, frtol: float,
                    ctol: float, mu_max: float, max_minor: int,
                    max_auglag: int,
                    step_cap: int | None = None) -> TronALMResult:
    """Solve a branch (``BRANCH``) or polar (``POLAR``) batch whose
    parameters are already packed: P (33, B) in ``pack_params``' rows, the
    uint8 flags ``active0`` (B,), the rest as ``tron_alm_branch`` /
    ``tron_alm_polar`` take them (``ops/branch_cuda.branch_pack`` writes
    them all). On a CPU tensor the instance's plain version runs on views
    of P."""
    opts = dict(gtol=gtol, frtol=frtol, ctol=ctol, mu_max=mu_max,
                max_minor=max_minor, max_auglag=max_auglag, step_cap=step_cap)
    plain = {BRANCH: tron_alm_branch_plain, POLAR: tron_alm_polar_plain}
    if inst not in plain:
        raise ValueError(f"tron_alm_packed: {inst.name} has no (33, B) "
                         "branch parameter block")
    if x0.device.type == "cpu":
        return plain[inst](x0, xl, xu, params_view(P), lam0, mu0,
                           active0=active0 != 0, **opts)
    if x0.device.type != "cuda":
        raise ValueError(f"tron_alm_packed: unsupported device {x0.device}")
    if active0.dtype != torch.uint8:
        raise ValueError("tron_alm_packed: active0 must be uint8")
    return _launch(inst, x0, xl, xu, P, lam0, mu0, active0, **opts)


def tron_alm_ramp(x0, xl, xu, params, lam0, mu0, *, gtol: float,
                  frtol: float, ctol: float, mu_max: float, max_minor: int,
                  max_auglag: int, step_cap: int | None = None,
                  active0: torch.Tensor | None = None) -> TronALMResult:
    """Solve the B ramp generator subproblems; x0/xl/xu (3, B), lam0 (1, B),
    mu0 (B,), params a dict of (B,) tensors under ``ramp.PARAM_KEYS``.
    Lanes with ``active0`` False come back untouched."""
    opts = dict(gtol=gtol, frtol=frtol, ctol=ctol, mu_max=mu_max,
                max_minor=max_minor, max_auglag=max_auglag, step_cap=step_cap)
    if x0.device.type == "cpu":
        return tron_alm_ramp_plain(x0, xl, xu, params, lam0, mu0,
                                   active0=active0, **opts)
    if x0.device.type != "cuda":
        raise ValueError(f"tron_alm_ramp: unsupported device {x0.device}")
    return _launch(RAMP, x0, xl, xu, pack_ramp_params(params), lam0, mu0,
                   active0, **opts)


def tron_alm_qpsub(x0, xl, xu, params, lam0, mu0, *, gtol: float,
                   frtol: float, ctol: float, mu_max: float, max_minor: int,
                   max_auglag: int, step_cap: int | None = None,
                   active0: torch.Tensor | None = None) -> TronALMResult:
    """Solve the B reduced line QPs; x0/xl/xu (6, B), lam0 (2, B), mu0 (B,),
    params a dict of G (6, 6, B, exactly symmetric), h0/w3/w4 (6, B) and
    fc/e3/e4/scale (B,). Lanes with ``active0`` False come back untouched."""
    opts = dict(gtol=gtol, frtol=frtol, ctol=ctol, mu_max=mu_max,
                max_minor=max_minor, max_auglag=max_auglag, step_cap=step_cap)
    if x0.device.type == "cpu":
        return tron_alm_qpsub_plain(x0, xl, xu, params, lam0, mu0,
                                    active0=active0, **opts)
    if x0.device.type != "cuda":
        raise ValueError(f"tron_alm_qpsub: unsupported device {x0.device}")
    return _launch(QPSUB, x0, xl, xu, pack_qpsub_params(params), lam0, mu0,
                   active0, **opts)


def tron_alm_polar(x0, xl, xu, params, lam0, mu0, *, gtol: float,
                   frtol: float, ctol: float, mu_max: float, max_minor: int,
                   max_auglag: int, step_cap: int | None = None,
                   active0: torch.Tensor | None = None) -> TronALMResult:
    """Solve the B line subproblems without line limits; x0/xl/xu (4, B),
    lam0 (0, B), mu0 (B,), params as ``tron_alm_branch``'s. Lanes with
    ``active0`` False come back untouched."""
    opts = dict(gtol=gtol, frtol=frtol, ctol=ctol, mu_max=mu_max,
                max_minor=max_minor, max_auglag=max_auglag, step_cap=step_cap)
    if x0.device.type == "cpu":
        return tron_alm_polar_plain(x0, xl, xu, params, lam0, mu0,
                                    active0=active0, **opts)
    if x0.device.type != "cuda":
        raise ValueError(f"tron_alm_polar: unsupported device {x0.device}")
    return _launch(POLAR, x0, xl, xu, pack_params(params), lam0, mu0,
                   active0, **opts)
