"""QP subproblem (qpsub): one-level ADMM as the QP solver inside an outer SQP.

Counterpart of ``exaadmm_tpu/models/qpsub/model.py`` (reference
qpsub_model.jl:8-31). Variables are deltas around an SQP base point; the
nonconvex line physics is replaced by

- an SQP-supplied 6x6 Hessian ``Hs`` per line over
  (w_ijR, w_ijI, w_i, w_j, th_i, th_j),
- two linearized equalities 1h (voltage product) and 1i (angle consistency)
  with rows ``LH_1h/RH_1h``, ``LH_1i/RH_1i``, eliminated exactly by solving
  the 2x2 system for (w_ijR, w_ijI); this gives an affine lift y8 = C x + d
  onto the ordering (t_ij, t_ji, w_ijR, w_ijI, w_i, w_j, th_i, th_j)
  (qpsub_eval_Ab_linelimit_kernel_cpu.jl: eval_*_red),
- linearized line limits 1j/1k with slacks t >= 0, handled by a per-line ALM
  (qpsub_auglag_Ab_linelimit_kernel_red_cpu.jl).

Every line is a lane of one TRON/ALM batch over the reduced 6 variables x =
(t_ij, t_ji, w_i, w_j, th_i, th_j) (``ops/tron_cuda.py::tron_alm_qpsub``:
the hand-written kernel on the GPU, the plain lockstep version on the CPU).
Per lane the objective is 1/2 x'Gx + h0'x + fc and the two constraints are
affine, c3 = w3'x + e3 and c4 = w4'x + e4, so f, g and H are closed form
(``qp_obj``, ``qp_cons``, ``qp_fgh``). G, w3, w4, e3 and e4 depend only on
the model and rho, which one-level ADMM never changes: ``solve_prep``
computes them once per solve; only h0 and fc change per iteration.

G is built exactly symmetric (lower triangle mirrored): the kernel keeps the
Hessian packed and reads one triangle, the plain version reads both, and
with a symmetric G the two see the same matrix.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ...ops import tron_cuda
from ...parallel.sharding import all_reduce_sum
from ...ops.tron import _dot, _hmatvec, _rowsum
from ...utils import tracing
from ...utils.environment import (Blocks, Parameters, Solution, SolutionQpsub,
                                  blocks_map, on_first_iteration)
from ...utils.grid_data import GridData, build_grid_data
from ..acopf import kernels

#: the SQP inputs of a QP, in the reference's argument order
QP_KEYS = ("Hs", "LH_1h", "RH_1h", "LH_1i", "RH_1i", "LH_1j", "RH_1j",
           "LH_1k", "RH_1k", "ls", "us", "pgmax", "pgmin", "qgmax", "qgmin",
           "c1", "c2", "Pd", "Qd")


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().to(torch.float64).numpy()


class ModelQpsub:
    """The grid, the parameters, the QP data (tensors on the grid's device)
    and the hooks the one-level driver calls.

    Line arrays: ``Hs`` (nline_padded, 6, 6), ``LH_1h``/``LH_1i``
    (nline_padded, 4), ``LH_1j``/``LH_1k`` (nline_padded, 2), the ``RH_*``
    (nline_padded,), ``ls``/``us`` (nline_padded, 6). Generator arrays
    (ngen,): ``pgmin``... and the shifted costs ``c1``/``c2``; bus arrays
    (nbus,): the residual loads ``Pd``/``Qd``. The derived arrays ``C``
    (nline_padded, 8, 6), ``dvec`` (nline_padded, 8), ``supY8``
    (nline_padded, 4, 8), ``vec_1j``/``vec_1k`` (nline_padded, 8) are
    computed here in numpy fp64, then cast.
    """

    #: the per-line arrays, which a run split across ranks cuts to the
    #: rank's window (``parallel/sharding.py::local_model``)
    LINE_FIELDS = ("Hs", "LH_1h", "RH_1h", "LH_1i", "RH_1i", "LH_1j", "RH_1j",
                   "LH_1k", "RH_1k", "ls", "us", "line_res", "C", "dvec",
                   "supY8", "vec_1j", "vec_1k")

    def __init__(self, grid: GridData, par: Parameters, qp: dict,
                 use_linelimit: bool = True):
        self.grid = grid
        self.par = par
        # use_linelimit=False drops the 1j/1k slacks and their ALM: the
        # reference's 4-variable branch kernel (qpsub_model.jl:135)
        self.use_linelimit = use_linelimit
        for k in QP_KEYS:
            setattr(self, k, qp[k])
        dt, dev = self.Hs.dtype, self.Hs.device
        nl = grid.nline_padded
        self.line_res = torch.zeros((nl, 4), dtype=dt, device=dev)
        # the rho-only QP pieces of a solve (solve_prep); None recomputes
        self._qp_cache = None

        # supY in the 8-dim ordering (rows pij qij pji qji over
        # [t_ij t_ji wijR wijI wi wj thi thj])
        z = np.zeros(nl)
        YftR, YftI, YffR, YffI, YtfR, YtfI, YttR, YttI = (
            _f64(getattr(grid, k)) for k in
            ("YftR", "YftI", "YffR", "YffI", "YtfR", "YtfI", "YttR", "YttI"))
        supY8 = np.stack([
            np.stack([z, z, YftR, YftI, YffR, z, z, z], -1),
            np.stack([z, z, -YftI, YftR, -YffI, z, z, z], -1),
            np.stack([z, z, YtfR, -YtfI, z, YttR, z, z], -1),
            np.stack([z, z, -YtfI, -YtfR, z, -YttI, z, z], -1),
        ], axis=1)  # (nl, 4, 8)

        LH_1h, LH_1i, LH_1j, LH_1k, RH_1h, RH_1i = (
            _f64(getattr(self, k)) for k in
            ("LH_1h", "LH_1i", "LH_1j", "LH_1k", "RH_1h", "RH_1i"))

        # 2x2 elimination of (w_ijR, w_ijI):
        #   [LH_1h[0] LH_1h[1]; LH_1i[0] LH_1i[1]] w = RH - LH[2:4] rest
        M = np.stack([LH_1h[:, :2], LH_1i[:, :2]], axis=1)  # (nl, 2, 2)
        det = M[:, 0, 0] * M[:, 1, 1] - M[:, 0, 1] * M[:, 1, 0]
        det = np.where(np.abs(det) > 1e-30, det, 1.0)
        Minv = (np.stack([
            np.stack([M[:, 1, 1], -M[:, 0, 1]], -1),
            np.stack([-M[:, 1, 0], M[:, 0, 0]], -1),
        ], axis=1) / det[:, None, None])
        # rest-dependence rows: 1h on (wi, wj) at cols 2,3 of the reduced
        # ordering (t_ij, t_ji, wi, wj, thi, thj); 1i on (thi, thj)
        R = np.zeros((nl, 2, 6))
        R[:, 0, 2] = LH_1h[:, 2]
        R[:, 0, 3] = LH_1h[:, 3]
        R[:, 1, 4] = LH_1i[:, 2]
        R[:, 1, 5] = LH_1i[:, 3]
        C_ij = -np.einsum("lab,lbk->lak", Minv, R)  # (nl, 2, 6)
        d_ij = np.einsum("lab,lb->la", Minv, np.stack([RH_1h, RH_1i], -1))

        C = np.zeros((nl, 8, 6))
        C[:, 0, 0] = 1.0
        C[:, 1, 1] = 1.0
        C[:, 2:4, :] = C_ij
        C[:, 4, 2] = 1.0
        C[:, 5, 3] = 1.0
        C[:, 6, 4] = 1.0
        C[:, 7, 5] = 1.0
        d = np.zeros((nl, 8))
        d[:, 2:4] = d_ij

        e0 = np.zeros((nl, 8)); e0[:, 0] = 1.0
        e1 = np.zeros((nl, 8)); e1[:, 1] = 1.0
        vec_1j = e0 + LH_1j[:, 0:1] * supY8[:, 0] + LH_1j[:, 1:2] * supY8[:, 1]
        vec_1k = e1 + LH_1k[:, 0:1] * supY8[:, 2] + LH_1k[:, 1:2] * supY8[:, 3]

        def f(a):
            return torch.as_tensor(a).to(device=dev, dtype=dt)

        self.C = f(C)
        self.dvec = f(d)
        self.supY8 = f(supY8)
        self.vec_1j = f(vec_1j)
        self.vec_1k = f(vec_1k)

    @property
    def nvar(self) -> int:
        return 2 * self.grid.ngen + 8 * self.grid.nline

    # ---- hooks called by the one-level driver ----
    def rho_norm(self, sol: SolutionQpsub) -> float:
        # once per solve, before the loop: the line part summed over ranks
        gd = self.grid
        rho = sol.base.rho
        line_sq = all_reduce_sum(
            torch.sum(rho.line * rho.line * gd.line_mask[:, None]), gd.mesh)
        return float(torch.sqrt(torch.sum(rho.gen * rho.gen) + line_sq))

    def one_level_reset(self, sol: SolutionQpsub) -> SolutionQpsub:
        b = sol.base
        zero = blocks_map(torch.zeros_like, b.z)
        return sol.replace(base=b.replace(
            z=zero, z_prev=zero, lz=blocks_map(torch.zeros_like, b.lz)))

    def solve_prep(self, sol: SolutionQpsub,
                   out: "ModelQpsub | None" = None) -> "ModelQpsub":
        """A copy of the model holding the solve's rho-only QP constants
        (``qp_solve_constants`` of ``sol``'s rho), which ``update_x`` then
        reuses on every iteration. With ``out``, a copy an earlier call
        returned, the constants are copied into its tensors and ``out`` is
        returned (a captured loop reads them where they are)."""
        cache = qp_solve_constants(self, sol.base.rho.line)
        if out is not None:
            for k, t in cache.items():
                out._qp_cache[k].copy_(t)
            return out
        m = copy.copy(self)
        m._qp_cache = cache
        return m

    def update_x(self, sol: SolutionQpsub, inner_iter):
        """x update: closed-form generators + the reduced-QP TRON/ALM batch;
        returns (new state, stats). The stats are tensors."""
        gd = self.grid
        b = sol.base
        u_gen = kernels.generator_update(
            b.u.gen, b.v.gen, b.z.gen, b.l.gen, b.rho.gen,
            self.pgmin, self.pgmax, self.qgmin, self.qgmax,
            self.c2, self.c1, gd.baseMVA,
        )
        x0, xl, xu, params, lam0, mu0, active0 = qpsub_inputs(
            self, sol, inner_iter)
        res = tron_cuda.tron_alm_qpsub(
            x0, xl, xu, params, lam0, mu0, active0=active0,
            **qpsub_tolerances(self.par, x0.dtype, self.use_linelimit))
        x = res.x                                    # (6, B)
        # lift back to the 8-dim ordering for flow recovery
        y = torch.einsum("lij,jl->il", self.C, x) + self.dvec.T  # (8, B)
        sqp_line = y[2:].T                           # (B, 6) Hs ordering
        flows = torch.einsum("lki,il->lk", self.supY8, y) + self.line_res
        u_line = torch.cat([flows, x[2:].T], dim=1)
        u_line = torch.where(active0[:, None], u_line, b.u.line)

        new = sol.replace(
            base=b.replace(u=Blocks(gen=u_gen, line=u_line)),
            sqp_line=torch.where(active0[:, None], sqp_line, sol.sqp_line),
            alm_lam_j=res.lam[0], alm_lam_k=res.lam[1], alm_mu=res.mu,
        )
        m = gd.line_mask
        sums = [torch.sum(res.alm_iters * m), torch.sum(res.minor_iters * m)]
        if gd.mesh is not None:
            sums = all_reduce_sum(torch.stack(sums), gd.mesh).unbind()
        stats = {
            "avg_auglag_it": sums[0] / gd.nline,
            "avg_minor_it": sums[1] / gd.nline,
        }
        return new, stats

    def update_xbar(self, sol: SolutionQpsub) -> SolutionQpsub:
        """Bus consensus with the QP's residual loads; keeps the old v."""
        b = sol.base
        v = kernels.bus_update(b.u, b.z, b.l, b.rho, self.grid,
                               Pd=self.Pd, Qd=self.Qd)
        return sol.replace(base=b.replace(v=v), v_prev=b.v)

    def update_l_single(self, sol: SolutionQpsub) -> SolutionQpsub:
        b = sol.base
        l = blocks_map(lambda ll, uu, vv, rr: ll + rr * (uu - vv),
                       b.l, b.u, b.v, b.rho)
        return sol.replace(base=b.replace(l=l))

    def update_residual(self, sol: SolutionQpsub, beta=0.0):
        """rp = u - v, rd = rho (v - v_prev) and the scalars (tensors)."""
        del beta
        gd = self.grid
        b = sol.base
        m = gd.line_mask[:, None]
        rp = blocks_map(lambda uu, vv: uu - vv, b.u, b.v)
        rd = blocks_map(lambda rr, vv, vp: rr * (vv - vp),
                        b.rho, b.v, sol.v_prev)

        qp_line = torch.einsum("li,lij,lj->l", sol.sqp_line, self.Hs,
                               sol.sqp_line)
        line_parts = torch.stack([
            torch.sum(rp.line**2 * m),
            torch.sum(rd.line**2 * m),
            0.5 * torch.sum(qp_line * gd.line_mask),
            torch.sum(b.l.line * rp.line * m)
            + 0.5 * torch.sum(b.rho.line * rp.line**2 * m),
        ])
        # lines split across ranks: the line partial sums in one all-reduce
        line_parts = all_reduce_sum(line_parts, gd.mesh)
        primres = torch.sqrt(torch.sum(rp.gen**2) + line_parts[0])
        dualres = torch.sqrt(torch.sum(rd.gen**2) + line_parts[1])

        pg = gd.baseMVA * b.u.gen[:, 0]
        objval = torch.sum(self.c2 * pg**2 + self.c1 * pg) + line_parts[2]
        auglag = objval + (
            torch.sum(b.l.gen * rp.gen)
            + 0.5 * torch.sum(b.rho.gen * rp.gen**2)
            + line_parts[3])
        scalars = {"primres": primres, "dualres": dualres,
                   "mismatch": primres, "objval": objval, "auglag": auglag}
        return sol.replace(base=b.replace(rp=rp, rd=rd)), scalars


def qp_solve_constants(model: ModelQpsub, rho_line: torch.Tensor) -> dict:
    """Rho-only pieces of the reduced per-line QP, hoisted out of the solve.

    With y = C x + d and z6 = y[2:] (C6 = C[:, 2:], d6 = d[2:]):
      A  = Hs + sum_k rho_k supY6_k supY6_k' + diag(rho[4:8]) on rows 2..5
      G  = C6' A C6 (lower triangle, mirrored);  Ad6 = A d6
      c3 = w3' x + e3 with w3 = C' v1j, e3 = v1j' d - r1j  (c4 analogous)
    """
    nl = rho_line.shape[0]
    dt, dev = rho_line.dtype, rho_line.device
    supY6 = model.supY8[:, :, 2:]            # (nl, 4, 6)
    A_br = model.Hs + torch.einsum("lk,lki,lkj->lij", rho_line[:, :4], supY6,
                                   supY6)
    eye = torch.eye(6, dtype=dt, device=dev)
    A_br = A_br + torch.cat([torch.zeros((nl, 2), dtype=dt, device=dev),
                             rho_line[:, 4:]], dim=1)[:, :, None] * eye[None]
    C6 = model.C[:, 2:, :]                   # (nl, 6, 6)
    d6 = model.dvec[:, 2:]                   # (nl, 6)
    Ad6 = torch.einsum("lkm,lm->lk", A_br, d6)
    G = torch.einsum("lki,lkm,lmj->lij", C6, A_br, C6)
    lower = torch.ones((6, 6), dtype=torch.bool, device=dev).tril()
    G = torch.where(lower, G, G.transpose(1, 2))
    w3 = torch.einsum("lki,lk->li", model.C, model.vec_1j)
    w4 = torch.einsum("lki,lk->li", model.C, model.vec_1k)
    e3 = torch.sum(model.vec_1j * model.dvec, dim=1) - model.RH_1j
    e4 = torch.sum(model.vec_1k * model.dvec, dim=1) - model.RH_1k
    return {
        "GT": G.permute(1, 2, 0).contiguous(),    # (6, 6, B)
        "Ad6": Ad6,                               # (B, 6)
        "fc0": 0.5 * torch.sum(d6 * Ad6, dim=1),  # (B,)
        "w3T": w3.T.contiguous(), "w4T": w4.T.contiguous(),  # (6, B)
        "e3": e3, "e4": e4,
    }


def reduced_qp_params(model: ModelQpsub, cache: dict, b_br: torch.Tensor
                      ) -> dict:
    """The batch's parameters: the solve constants and the iteration's
    h0 = C6' (A d6 + b) and fc = 1/2 d6' A d6 + b' d6."""
    C6 = model.C[:, 2:, :]
    d6 = model.dvec[:, 2:]
    h0 = torch.einsum("lki,lk->li", C6, cache["Ad6"] + b_br)
    fc = cache["fc0"] + torch.sum(b_br * d6, dim=1)
    return {
        "G": cache["GT"], "h0": h0.T, "w3": cache["w3T"], "w4": cache["w4T"],
        "fc": fc, "e3": cache["e3"], "e4": cache["e4"],
        "scale": torch.full_like(fc, model.par.scale),
    }


# ---- the reduced QP, closed form; sums run in index order, and
# csrc/tron_alm_qpsub.cu repeats every operation ----
def qp_cons(x, p):
    """(c3, c4) = (w3'x + e3, w4'x + e4), (2, B)."""
    return torch.stack([_dot(p["w3"], x) + p["e3"],
                        _dot(p["w4"], x) + p["e4"]])


def qp_obj(x, p, lam, mu):
    """Full ALM objective times ``scale``: 1/2 x'Gx + h0'x + fc
    + lam.c + mu/2 |c|^2."""
    c3, c4 = qp_cons(x, p)
    Gx = _hmatvec(p["G"], x)
    f = (_rowsum((0.5 * Gx + p["h0"]) * x) + p["fc"]
         + lam[0] * c3 + lam[1] * c4 + 0.5 * mu * (c3 * c3 + c4 * c4))
    return f * p["scale"]


def qp_fgh(x, p, lam, mu):
    """(f (B,), g (6, B), H (6, 6, B)) of ``qp_obj``: with kap = lam + mu c,
    g = (Gx + h0 + kap3 w3 + kap4 w4) scale and
    H = (G + mu (w3 w3' + w4 w4')) scale."""
    c3, c4 = qp_cons(x, p)
    kap3 = lam[0] + mu * c3
    kap4 = lam[1] + mu * c4
    G, h0, w3, w4, scale = p["G"], p["h0"], p["w3"], p["w4"], p["scale"]
    Gx = _hmatvec(G, x)
    f = (_rowsum((0.5 * Gx + h0) * x) + p["fc"]
         + lam[0] * c3 + lam[1] * c4 + 0.5 * mu * (c3 * c3 + c4 * c4)) * scale
    g = (Gx + h0 + kap3 * w3 + kap4 * w4) * scale
    H = (G + mu * (w3[:, None] * w3[None, :] + w4[:, None] * w4[None, :])) \
        * scale
    return f, g, H


def qpsub_tolerances(par: Parameters, dtype, use_linelimit: bool = True
                     ) -> dict:
    """The batch's TRON/ALM tolerances (qpsub/model.py:280-291 of the JAX
    package): floored at multiples of the dtype's epsilon, mu_max uncapped,
    one ALM round without line limits."""
    eps = float(torch.finfo(dtype).eps)
    return dict(gtol=max(par.tron_gtol, 40.0 * eps),
                frtol=max(par.tron_frtol, 10.0 * eps),
                ctol=max(par.alm_ctol, 300.0 * eps),
                mu_max=par.mu_max, max_minor=par.tron_max_minor,
                max_auglag=par.max_auglag if use_linelimit else 1,
                step_cap=par.tron_step_cap)


def qpsub_inputs(model: ModelQpsub, sol: SolutionQpsub, inner_iter):
    """The batch's inputs: x0, xl, xu (6, B), params, lam0 (2, B), mu0 (B,)
    and active0 (B,).

    ``inner_iter`` is the one-level driver's global iteration count, so the
    ALM penalty restarts at 10 once per solve; the multipliers warm-start
    across iterations. Without line limits the slacks are pinned at 0 and
    lam0 = mu0 = 0."""
    gd = model.grid
    b = sol.base
    nl = b.u.line.shape[0]
    dt, dev = b.u.gen.dtype, b.u.gen.device
    lL, rL = b.l.line, b.rho.line
    vz = b.v.line - b.z.line

    # b_br = sum_k (l_k - rho_k (v_k - z_k - res_k)) supY6_k + rows 4..7, the
    # only iteration-varying piece of the reduced QP
    supY6 = model.supY8[:, :, 2:]
    coef = lL[:, :4] - rL[:, :4] * (vz[:, :4] - model.line_res)
    b_br = torch.einsum("lk,lki->li", coef, supY6)
    b_br = b_br + torch.cat([torch.zeros((nl, 2), dtype=dt, device=dev),
                             lL[:, 4:] - rL[:, 4:] * vz[:, 4:]], dim=1)
    cache = model._qp_cache
    if cache is None or cache["GT"].shape[-1] != nl:
        cache = qp_solve_constants(model, rL)
    params = reduced_qp_params(model, cache, b_br)

    zerov = torch.zeros(nl, dtype=dt, device=dev)
    t_hi = torch.full_like(zerov, 200000.0) if model.use_linelimit else zerov
    xl = torch.cat([zerov[None], zerov[None], model.ls[:, 2:].T])
    xu = torch.cat([t_hi[None], t_hi[None], model.us[:, 2:].T])
    x0 = torch.cat([zerov[None], zerov[None], sol.sqp_line[:, 2:].T])
    x0 = torch.clamp(x0, min=xl, max=xu)

    mu0 = on_first_iteration(inner_iter, torch.full_like(zerov, 10.0),
                             sol.alm_mu)
    lam0 = torch.stack([sol.alm_lam_j, sol.alm_lam_k])
    if not model.use_linelimit:
        mu0 = torch.zeros_like(mu0)
        lam0 = torch.zeros_like(lam0)
    return x0, xl, xu, params, lam0, mu0, gd.line_mask > 0.5


@tracing.spanned("entry.build_model")
def build_model(data_or_grid, par: Parameters, qp_inputs: dict, *,
                use_linelimit: bool = True, tight_factor: float = 1.0,
                pad_lines_to: int = 1, dtype=torch.float64,
                device="cpu") -> ModelQpsub:
    """``qp_inputs``: the numpy arrays of ``QP_KEYS``; Hs (6 nline, 6) or
    (nline, 6, 6) (the reference solve_qpsub's positional arguments).

    ``pad_lines_to`` pads the line batch to a multiple, as the reference's
    MPI padding (qpsub_model.jl:139-142); padded lanes get inert,
    well-conditioned QP data and are masked out everywhere."""
    if isinstance(data_or_grid, GridData):
        gd = data_or_grid
    else:
        gd = build_grid_data(data_or_grid, tight_factor=tight_factor,
                             pad_lines_to=pad_lines_to, dtype=dtype,
                             device=device)
    q = {k: np.asarray(v, np.float64) for k, v in qp_inputs.items()}
    Hs = q["Hs"]
    if Hs.ndim == 2:
        Hs = Hs.reshape(gd.nline, 6, 6)
    npad = gd.nline_padded - gd.nline
    if npad > 0:
        def pad(a, fill=0.0):
            w = [(0, npad)] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, w, constant_values=fill)

        Hs = np.concatenate(
            [Hs, np.tile(np.eye(6)[None], (npad, 1, 1))], axis=0)
        # identity 2x2 elimination rows; zero constraint rows; unit box
        q["LH_1h"] = pad(q["LH_1h"]); q["LH_1h"][gd.nline:, 0] = 1.0
        q["LH_1i"] = pad(q["LH_1i"]); q["LH_1i"][gd.nline:, 1] = 1.0
        for k in ("RH_1h", "RH_1i", "LH_1j", "RH_1j", "LH_1k", "RH_1k", "ls"):
            q[k] = pad(q[k])
        q["us"] = pad(q["us"], 1.0)
    obj_scale = par.obj_scale
    q["Hs"] = Hs * obj_scale
    q["c1"] = q["c1"] * obj_scale
    q["c2"] = q["c2"] * obj_scale
    dev = gd.pgmin.device
    qp = {k: torch.as_tensor(q[k]).to(device=dev, dtype=gd.pgmin.dtype)
          for k in QP_KEYS}
    return ModelQpsub(grid=gd, par=par, qp=qp, use_linelimit=use_linelimit)


@tracing.spanned("entry.init_solution")
def init_solution(model: ModelQpsub, rho_pq: float, rho_va: float
                  ) -> SolutionQpsub:
    """qpsub flat start (qpsub_init_solution_cpu.jl:8-67): v gens at delta
    bound midpoints, sqp_line at (ls+us)/2 pushed through supY, rho = rho_pq
    for gens and rho_va on all 8 line rows."""
    gd = model.grid
    dt, dev = model.Hs.dtype, model.Hs.device
    nl = gd.nline_padded
    base = Solution.zeros(gd.ngen, nl, dt, dev)

    rho = Blocks(gen=torch.full((gd.ngen, 2), rho_pq, dtype=dt, device=dev),
                 line=torch.full((nl, 8), rho_va, dtype=dt, device=dev))
    v_gen = torch.stack([0.5 * (model.pgmin + model.pgmax),
                         0.5 * (model.qgmin + model.qgmax)], dim=-1)
    sqp0 = 0.5 * (model.ls + model.us)                     # (nl, 6)
    supY6 = model.supY8[:, :, 2:]                          # (nl, 4, 6)
    flows0 = torch.einsum("lki,li->lk", supY6, sqp0)
    v_line = torch.cat([flows0, sqp0[:, 2:]], dim=1) * gd.line_mask[:, None]

    base = base.replace(rho=rho, v=Blocks(gen=v_gen, line=v_line))
    zero = torch.zeros(nl, dtype=dt, device=dev)
    return SolutionQpsub(base=base, sqp_line=sqp0, v_prev=base.v,
                         alm_lam_j=zero, alm_lam_k=zero.clone(),
                         alm_mu=torch.full_like(zero, 10.0))


def _qp_obj_grad(model: ModelQpsub, sol: SolutionQpsub, x_red, b_br, A_br
                 ) -> torch.Tensor:
    """Gradient of the summed reduced-QP ALM objective over the lifted
    8-dim line variables, with respect to x_red (6, B), by autograd."""
    d = model.dvec.T
    C = model.C.permute(1, 2, 0)                  # (8, 6, B)
    A = A_br.permute(1, 2, 0)                     # (6, 6, B)
    b = b_br.T
    v1j, v1k = model.vec_1j.T, model.vec_1k.T
    with torch.enable_grad():
        X = x_red.detach().clone().requires_grad_(True)
        y = _hmatvec(C, X) + d
        z6 = y[2:]
        fval = _rowsum((0.5 * _hmatvec(A, z6) + b) * z6)
        c3 = _dot(v1j, y) - model.RH_1j
        c4 = _dot(v1k, y) - model.RH_1k
        fval = (fval + sol.alm_lam_j * c3 + sol.alm_lam_k * c4
                + 0.5 * sol.alm_mu * (c3 * c3 + c4 * c4))
        total = torch.sum(fval * model.par.scale)
        (grad,) = torch.autograd.grad(total, X)
    return grad


def poststep(model: ModelQpsub, sol: SolutionQpsub) -> dict:
    """Collect the SQP outputs (qpsub_admm_prepoststep_cpu.jl) as numpy: the
    d* solution blocks, per-bus consensus averages, the dual-infeasibility
    KKT vector, and the 14h/14i/14j/14k constraint multipliers."""
    gd = model.grid
    nl, nb = gd.nline, gd.nbus
    npl = gd.nline_padded
    dt, dev = model.Hs.dtype, model.Hs.device
    u_gen = _f64(sol.base.u.gen)
    u_line = _f64(sol.base.u.line)[:nl]
    sqp = _f64(sol.sqp_line)[:nl]
    Hs = _f64(model.Hs)[:nl]
    f = gd.line_from.cpu().numpy()[:nl]
    t = gd.line_to.cpu().numpy()[:nl]

    dpg_sol = u_gen[:, 0].copy()
    dqg_sol = u_gen[:, 1].copy()
    dline_var = sqp.T.copy()
    dline_fl = u_line[:, :4].T.copy()

    cnt = np.bincount(f, minlength=nb) + np.bincount(t, minlength=nb)
    cnt = np.maximum(cnt, 1)
    dw_sol = (np.bincount(f, weights=sqp[:, 2], minlength=nb)
              + np.bincount(t, weights=sqp[:, 3], minlength=nb)) / cnt
    dtheta_sol = (np.bincount(f, weights=sqp[:, 4], minlength=nb)
                  + np.bincount(t, weights=sqp[:, 5], minlength=nb)) / cnt

    # dual infeasibility: unscaled KKT stationarity pieces
    pg_di = 2.0 * _f64(model.c2) * float(gd.baseMVA) ** 2 * u_gen[:, 0]
    line_di = np.einsum("lij,lj->li", Hs, sqp).reshape(-1)
    dual_infeas = np.concatenate([pg_di, line_di])

    # multipliers for 14h/14i/14j/14k from the reduced-QP gradient at the
    # solution (qpsub_auglag_Ab_...red_cpu.jl:139-156)
    b = sol.base
    lL, rL = b.l.line, b.rho.line
    vz = b.v.line - b.z.line
    supY6 = model.supY8[:, :, 2:]
    zero2 = torch.zeros((npl, 2), dtype=dt, device=dev)
    A_br = model.Hs + torch.einsum("lk,lki,lkj->lij", rL[:, :4], supY6,
                                   supY6)
    A_br = A_br + torch.cat([zero2, rL[:, 4:]], dim=1)[:, :, None] * \
        torch.eye(6, dtype=dt, device=dev)[None]
    coef = lL[:, :4] - rL[:, :4] * (vz[:, :4] - model.line_res)
    b_br = torch.einsum("lk,lki->li", coef, supY6)
    b_br = b_br + torch.cat([zero2, lL[:, 4:] - rL[:, 4:] * vz[:, 4:]], dim=1)

    # the t slacks from the 1j/1k rows at the solution's flows
    flows = b.u.line[:, :4] - model.line_res
    t_ij = model.RH_1j - torch.sum(model.LH_1j * flows[:, :2], dim=1)
    t_ji = model.RH_1k - torch.sum(model.LH_1k * flows[:, 2:4], dim=1)
    x_red = torch.cat([t_ij[None], t_ji[None], sol.sqp_line[:, 2:].T])
    trg = _f64(_qp_obj_grad(model, sol, x_red, b_br, A_br)).T[:nl]  # (nl, 6)

    LH_1h = _f64(model.LH_1h)[:nl]
    LH_1i = _f64(model.LH_1i)[:nl]
    Yd = {k: _f64(getattr(gd, k))[:nl]
          for k in ("YftR", "YftI", "YtfR", "YtfI")}
    pij, qij, pji, qji = (u_line[:, k] for k in range(4))
    tmp14_i = np.stack([2 * pij * Yd["YftR"] - 2 * qij * Yd["YftI"],
                        2 * pij * Yd["YftI"] + 2 * qij * Yd["YftR"]], axis=1)
    tmp14_h = np.stack([2 * pji * Yd["YtfR"] - 2 * qji * Yd["YtfI"],
                        -2 * pji * Yd["YtfI"] - 2 * qji * Yd["YtfR"]], axis=1)
    rhs = (trg[:, :1] * tmp14_i + trg[:, 1:2] * tmp14_h
           + np.einsum("lij,lj->li", Hs[:, :2, :], sqp)
           + _f64(b_br)[:nl, :2])                              # (nl, 2)
    # inv([[h0, i0], [h1, i1]]) applied to rhs, closed form
    a, bb = LH_1h[:, 0], LH_1i[:, 0]
    c, dd = LH_1h[:, 1], LH_1i[:, 1]
    det = a * dd - bb * c
    lam = np.zeros((4, nl))
    lam[0] = -(dd * rhs[:, 0] - bb * rhs[:, 1]) / det
    lam[1] = -(-c * rhs[:, 0] + a * rhs[:, 1]) / det
    lam[2] = -np.abs(trg[:, 0])
    lam[3] = -np.abs(trg[:, 1])

    return {
        "dpg_sol": dpg_sol, "dqg_sol": dqg_sol,
        "dline_var": dline_var, "dline_fl": dline_fl,
        "dw_sol": dw_sol, "dtheta_sol": dtheta_sol,
        "dual_infeas": dual_infeas, "lambda": lam,
    }
