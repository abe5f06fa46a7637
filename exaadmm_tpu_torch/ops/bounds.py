"""Least times the H100 could take for the kernels' work.

Each kernel's bound is the larger of two times: the bytes its function must
move (each input read once, each output written once) over the card's
memory rate, and its operations over the card's peak rate for their type.
The rates are NVIDIA's data sheet for the H100 SXM: 3.35 TB/s of HBM3,
34 TFLOP/s fp64 and 67 TFLOP/s fp32 outside the tensor cores.

The TRON/ALM kernels' work depends on the data: a lane runs as many
trust-region steps and ALM rounds as it needs. Their operation count is
taken from the kernel's own per-lane ``minor_iters`` and ``alm_iters`` and a
per-step count read off the source (``csrc/tron_alm.cuh`` and the problem's
``obj``/``cons``/``gh``), counting each add, subtract, multiply, divide,
square root, sine and cosine as one operation and comparisons as none.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {8: 34e12, 4: 67e12}   # by item size: fp64, fp32

# Cauchy-point tests per trust-region step (the first test plus the loop's
# trials) and projected-search trials per step: the means over the branch
# batch of synthetic 9241 buses at its first inner iteration (prox targets
# perturbed by N(0, 0.05), seed 0, step_cap 50), counted on the CPU with the
# plain version
CAUCHY_TESTS_PER_STEP = 2.30
PRSRCH_TRIALS_PER_STEP = 1.0005

# per instance: (n, ncon, nparam, ops of gh, of obj, of cons), by hand from
# the problem sources
_PROBLEMS = {
    "tron_alm_branch": (6, 2, 33, 420, 62, 30),
    "tron_alm_qpsub": (6, 2, 43, 240, 124, 24),
    "tron_alm_ramp": (3, 1, 9, 25, 25, 2),
    # the branch's gh and obj without the ALM terms, slack rows and cross
    # terms; no constraints
    "tron_alm_polar": (4, 0, 33, 230, 45, 0),
}


def bound(nbytes: float, ops: float, itemsize: int = 8) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for moving ``nbytes`` and doing
    ``ops`` operations of ``itemsize``-byte floats."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[itemsize]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def scatter_bytes(nrows: int, nseg: int, nch: int, itemsize: int) -> dict:
    """Bytes of one bus scatter of (nrows, nch) values into nseg segments:
    the values, the int32 CSR (idx over the rows, ptr of nseg + 1) and the
    (nseg, nch) output."""
    parts = {"vals": nrows * nch * itemsize, "idx": nrows * 4,
             "ptr": (nseg + 1) * 4, "out": nseg * nch * itemsize}
    parts["total"] = sum(parts.values())
    return parts


def scatter_ops(nrows: int, nch: int) -> int:
    """Adds of one bus scatter: one per row and channel."""
    return nrows * nch


def tron_bytes(name: str, B: int, itemsize: int) -> dict:
    """Bytes of one TRON/ALM batch of B lanes: per lane x0, xl, xu, the
    parameters, lam0 and mu0 read, the active flag (one byte) read, and x,
    lam, mu and cviol written with two int32 counts."""
    n, ncon, nparam = _PROBLEMS[name][:3]
    read = (3 * n + nparam + ncon + 1) * itemsize + 1
    write = (n + ncon + 2) * itemsize + 2 * 4
    return {"read": B * read, "write": B * write,
            "total": B * (read + write)}


def _dot(n: int) -> int:
    return 2 * n - 1


def _hmatvec(n: int) -> int:
    return n * (2 * n - 1)


def _qval(n: int) -> int:
    return 2 * _dot(n) + _hmatvec(n) + 2


def step_ops(name: str) -> float:
    """Operations of one trust-region step of one lane, with the mean
    Cauchy and projected-search trials above (no shift of the Newton
    system: the first Cholesky fails on about 1 step in 85,000)."""
    n, _, _, gh, obj, _ = _PROBLEMS[name]
    s_of = 3 * n
    cauchy_ok = s_of + _dot(n) + 1 + _qval(n) + _dot(n) + 1
    cauchy = CAUCHY_TESTS_PER_STEP * (cauchy_ok + 1) + s_of + n
    newton = _hmatvec(n) + 2 * n + 3 * n * (n + 1) // 2
    chol = sum(2 + 2 * j + 1 + (n - 1 - j) * (2 * j + 1) for j in range(n))
    chol += n + n * (n - 1) + n * (n - 1) + n    # the two substitutions
    trqsol = 3 * _dot(n) + 10 + n
    prsrch = 2 + PRSRCH_TRIALS_PER_STEP * (4 * n + _dot(n) + _qval(n) + 3)
    ratio = n + obj + _qval(n) + 1 + _dot(n) + _dot(n) + 1 + 12
    return gh + cauchy + newton + chol + trqsol + prsrch + ratio


def alm_ops(name: str) -> int:
    """Operations of one ALM round of one lane (the constraints, the
    multiplier or penalty update with its pow, and the objective's
    update)."""
    _, ncon, _, _, obj, cons = _PROBLEMS[name]
    return cons + 2 * ncon + 3 + max(obj, 6 + 2 * ncon)


def tron_ops(name: str, minor_iters, alm_iters, B: int) -> float:
    """Operations of one TRON/ALM batch whose lanes ran ``minor_iters``
    steps and ``alm_iters`` ALM rounds in all (sums over the lanes); every
    lane also evaluates its objective once and a pow at the start."""
    _, _, _, _, obj, _ = _PROBLEMS[name]
    return (float(minor_iters) * step_ops(name)
            + float(alm_iters) * alm_ops(name) + B * (obj + 2))


# the ACOPF hook kernels (``csrc/acopf_hooks.cu``): per kernel, the values
# read and written as multiples of (N, the elements of one ADMM vector,
# 2 ngen + 8 nline; ngen; nline; nbus; the residual's blocks), by hand from
# the source: the bytes each input and output must move once. The
# writeback reads columns 0-3 of the line blocks only; index arrays are
# int64 (counted apart, in ``_HOOK_INDEX``).
_HOOK_VALUES = {
    #                    (N, ngen, nline, nbus, nblocks): read, then write
    "acopf_z": ((5, 0, 0, 0, 0), (1, 0, 0, 0, 0)),
    "acopf_l": ((2, 0, 0, 0, 0), (1, 0, 0, 0, 0)),
    "acopf_lz": ((2, 0, 0, 0, 0), (1, 0, 0, 0, 0)),
    "acopf_generator": ((0, 14, 0, 0, 0), (0, 2, 0, 0, 0)),
    "acopf_bus_values": ((0, 8, 33, 0, 0), (0, 4, 16, 0, 0)),
    "acopf_bus_solve": ((0, 0, 0, 16, 0), (0, 0, 0, 4, 0)),
    "acopf_bus_writeback": ((0, 8, 16, 4, 0), (0, 2, 8, 0, 0)),
    "acopf_residual_partials": ((7, 3, 1, 0, 0), (2, 0, 0, 0, 15)),
    "acopf_residual_final": ((0, 0, 0, 0, 15), (0, 0, 0, 0, 0)),
}
# int64 index values read: (per nline, per ngen)
_HOOK_INDEX = {"acopf_bus_writeback": (2, 1)}
# operations per unit, by hand from the source (each add, subtract,
# multiply, divide, negation and square root one; comparisons none):
# (per N element, per generator, per line, per bus, per block, fixed)
_HOOK_OPS = {
    "acopf_z": (7, 0, 0, 0, 0, 0),
    "acopf_l": (3, 0, 0, 0, 0, 0),
    "acopf_lz": (2, 0, 0, 0, 0, 0),
    "acopf_generator": (0, 19, 0, 0, 0, 0),
    "acopf_bus_values": (0, 9, 40, 0, 0, 0),
    "acopf_bus_solve": (0, 0, 0, 38, 0, 0),
    "acopf_bus_writeback": (0, 9, 16, 0, 0, 0),
    # rp, rd, rp - z and 8 products per element, the mask's 7 multiplies
    # on a line element, the 7 adds its terms need; the objective's 7 per
    # generator
    "acopf_residual_partials": (0, 45, 208, 0, 0, 0),
    "acopf_residual_final": (0, 0, 0, 0, 15, 20),
}


def hook_bytes(name: str, ngen: int, nline: int, nbus: int, itemsize: int,
               nblocks: int = 0, scalar_tensor: bool = False) -> dict:
    """Bytes of one launch of the hook kernel ``name`` on ``ngen``
    generators, ``nline`` (padded) lines and ``nbus`` buses; ``nblocks``
    the residual's blocks; ``scalar_tensor`` a beta read from the device."""
    n = 2 * ngen + 8 * nline
    units = (n, ngen, nline, nbus, nblocks)
    read, write = (sum(a * b for a, b in zip(c, units))
                   for c in _HOOK_VALUES[name])
    per_line, per_gen = _HOOK_INDEX.get(name, (0, 0))
    parts = {"read": read * itemsize + (per_line * nline + per_gen * ngen)
             * 8 + (itemsize if scalar_tensor else 0),
             "write": write * itemsize}
    parts["total"] = parts["read"] + parts["write"]
    return parts


def hook_ops(name: str, ngen: int, nline: int, nbus: int,
             nblocks: int = 0) -> int:
    """Operations of one launch of the hook kernel ``name``."""
    n = 2 * ngen + 8 * nline
    return sum(a * b for a, b in zip(_HOOK_OPS[name],
                                     (n, ngen, nline, nbus, nblocks, 1)))


# the branch update's pack and unpack (``csrc/branch_io.cu``): values a lane
# reads and writes, by hand from the source, for n = 6 (line limits) and
# n = 4 (polar): (state-type values read, solve-type values read, state
# written, solve written, bytes of int32 and uint8 read, written)
_BRANCH_IO = {
    # u (8, or columns 4-7), v, z, l, rho (32), lam1, lam2, mu, the 8
    # admittances, 4 bound pairs, rate_a, the mask; x0, xl, xu, the 33
    # parameter rows, lam0, mu0 and the flag
    ("branch_pack", 6): (61, 0, 0, 54, 0, 1),
    ("branch_pack", 4): (53, 0, 0, 46, 0, 1),
    # the 8 admittances and the mask; x's rows 0-3 and cviol; the new row;
    # the two int32 counts and the flag read, the lane steps written (the
    # old row of an inactive lane and the widened ALM state of mixed
    # precision are added apart)
    ("branch_unpack", 6): (9, 5, 8, 0, 9, 4),
    ("branch_unpack", 4): (9, 5, 8, 0, 9, 4),
}
# operations a lane, by hand from the source (each add, subtract,
# multiply, negation, square root, sine and cosine one; comparisons none):
# the pack's square roots, slacks and prox targets; the unpack's angle,
# trig, products, flows, lane steps and masked counts
_BRANCH_IO_OPS = {("branch_pack", 6): 19, ("branch_pack", 4): 10,
                  ("branch_unpack", 6): 37, ("branch_unpack", 4): 37}


def branch_io_bytes(name: str, B: int, n: int, itemsize: int,
                    mixed: bool = False, inactive: int = 0) -> dict:
    """Bytes of one launch of the branch pack, unpack or stats kernel
    (``name``) over B lanes of the n-variable batch: ``itemsize`` the
    state's, the solve's fp32 under ``mixed``; ``inactive`` lanes whose old
    row the unpack copies. The unpack's (3, nblocks) stats partials are
    counted as written there and read by ``branch_stats``."""
    solve = 4 if mixed else itemsize
    nb = -(-B // 256)
    if name == "branch_stats":
        parts = {"read": 3 * nb * itemsize, "write": 5 * itemsize}
    else:
        rs, rv, ws, wv, ri, wi = _BRANCH_IO[(name, n)]
        read = B * (rs * itemsize + rv * solve + ri)
        write = B * (ws * itemsize + wv * solve + wi)
        if name == "branch_unpack":
            read += inactive * 8 * itemsize
            write += 3 * nb * itemsize
            if mixed and n == 6:   # lam and mu read, widened and written
                read += B * 3 * solve
                write += B * 3 * itemsize
        parts = {"read": read, "write": write}
    parts["total"] = parts["read"] + parts["write"]
    return parts


def branch_io_ops(name: str, B: int, n: int) -> int:
    """Operations of one launch of the branch pack, unpack or stats
    kernel over B lanes."""
    if name == "branch_stats":
        return 3 * -(-B // 256) + 2
    return B * _BRANCH_IO_OPS[(name, n)]


# the multi-period hook kernels (``csrc/mpacopf_hooks.cu``): per kernel, the
# values read and written as multiples of (N, the elements of the ADMM
# blocks of all periods, T (2 ngen + 8 nline); G = T ngen, a generator
# column or the ramp block; L = T nline, a line column of all periods;
# B = (T - 1) ngen, the ramp lanes or the ramp rows after period 1; ngen,
# a grid generator array; nline, the line mask; T nbus; the residual's
# block sums, 13 T nblocks), by hand from the source: the bytes each input
# and output must move once. Index arrays are int64 (counted apart, in
# ``_MP_INDEX``).
_MP_VALUES = {
    #              (N, G, L, B, ngen, nline, T nbus, sums): read, then write
    # the pg columns of u, l, rho, z (B each) and of v (G); the ramp's u,
    # s, l, rho, z, alm_mu, alm_xi (B each); c2, c1, pgmin, pgmax, the ramp
    # rate; x0, xl, xu, the 9 parameter rows, lam0 and mu0
    "mp_ramp_pack": ((0, 1, 0, 11, 5, 0, 0, 0), (0, 0, 0, 20, 0, 0, 0, 0)),
    # the qg columns of v, z, l, rho (G each), their pg columns of period 1
    # (ngen each), the six generator arrays, alm_xi of period 1, the
    # batch's x, lam and mu (5 B); u_gen and the four new ramp rows
    "mp_generator_unpack": ((0, 4, 0, 5, 11, 0, 0, 0),
                            (0, 6, 0, 0, 0, 0, 0, 0)),
    # the 4 line blocks (32 L), the mask, the 4 generator blocks (8 G), the
    # ramp's u, z, l, rho after period 1 (4 B); the arc and generator rows
    "mp_bus_values": ((0, 8, 32, 4, 0, 1, 0, 0), (0, 4, 16, 0, 0, 0, 0, 0)),
    # the folded sums (12 T nbus), the loads (2 T nbus), the two shunts
    # (counted as T nbus / T each, below); the (T, nbus, 4) rows
    "mp_bus_solve": ((0, 0, 0, 0, 0, 0, 14, 0), (0, 0, 0, 0, 0, 0, 4, 0)),
    # columns 0-3 of the 4 line blocks (16 L), the 4 generator blocks, the
    # ramp terms, the buses' rows; v
    "mp_bus_writeback": ((0, 8, 16, 4, 0, 0, 4, 0), (0, 2, 8, 0, 0, 0, 0, 0)),
    # five ADMM vectors; the ramp's u, l, rho, lz and v's pg column before
    # the last period; z and the ramp's z
    "mp_z": ((5, 4, 0, 1, 0, 0, 0, 0), (1, 1, 0, 0, 0, 0, 0, 0)),
    "mp_l": ((2, 2, 0, 0, 0, 0, 0, 0), (1, 1, 0, 0, 0, 0, 0, 0)),
    "mp_lz": ((2, 2, 0, 0, 0, 0, 0, 0), (1, 1, 0, 0, 0, 0, 0, 0)),
    # u, v, z, z_prev; the ramp's u, z, z_prev and v's pg column; the mask,
    # c2, c1, c0; rp, rd and the block sums
    "mp_residual_partials": ((4, 3, 0, 1, 3, 1, 0, 0),
                             (2, 0, 0, 0, 0, 0, 0, 1)),
    "mp_residual_final": ((0, 0, 0, 0, 0, 0, 0, 1), (0, 0, 0, 0, 0, 0, 0, 0)),
}
# int64 index values read: (per nline, per ngen)
_MP_INDEX = {"mp_bus_writeback": (2, 1)}
# operations per unit, by hand from the source (each add, subtract,
# multiply, divide, negation and square root one; comparisons none):
# (per N element, per G, per L, per B, per T nbus, per block sum, fixed,
# per period)
_MP_OPS = {
    # the two cost products, t_p, t_h and the negated ramp rate
    "mp_ramp_pack": (0, 0, 0, 5, 0, 0, 0, 0),
    # qg's 6; pg's closed form (9) in period 1, counted on every row
    "mp_generator_unpack": (0, 15, 0, 0, 0, 0, 0, 0),
    # the arc rows' 20 a side; the pg row with the blend (9), the qg row
    # (3), the two reciprocals
    "mp_bus_values": (0, 14, 40, 0, 0, 0, 0, 0),
    "mp_bus_solve": (0, 0, 0, 0, 38, 0, 0, 0),
    "mp_bus_writeback": (0, 13, 16, 0, 0, 0, 0, 0),
    # 7 per element; the ramp's 8 and its mask
    "mp_z": (7, 9, 0, 0, 0, 0, 0, 0),
    "mp_l": (3, 4, 0, 0, 0, 0, 0, 0),
    "mp_lz": (2, 2, 0, 0, 0, 0, 0, 0),
    # rp, rd, rp - z and 4 squares per element, the mask's 4 multiplies
    # on a line element (32 a line), the tree's adds (one per sum row and
    # element); the ramp's 13; the objective's 7 per generator
    "mp_residual_partials": (7, 20, 32, 0, 0, 0, 0, 0),
    # one add per block sum; per period 4 x (2 adds and a square root) and
    # the objective's add
    "mp_residual_final": (0, 0, 0, 0, 0, 1, 0, 13),
}


def mpacopf_hook_bytes(name: str, T: int, ngen: int, nline: int, nbus: int,
                       itemsize: int, nblocks: int = 0,
                       scalar_tensor: bool = False) -> dict:
    """Bytes of one launch of the multi-period hook kernel ``name`` on T
    periods of ``ngen`` generators, ``nline`` (padded) lines and ``nbus``
    buses; ``nblocks`` the residual's blocks per period; ``scalar_tensor``
    a beta or inner_iter read from the device."""
    n = T * (2 * ngen + 8 * nline)
    units = (n, T * ngen, T * nline, (T - 1) * ngen, ngen, nline, T * nbus,
             13 * T * nblocks)
    read, write = (sum(a * b for a, b in zip(c, units))
                   for c in _MP_VALUES[name])
    if name == "mp_bus_solve":   # the shunts, read once
        read += 2 * nbus
    if name == "mp_generator_unpack" and T == 1:   # no batch, no ramp rows
        read -= ngen
        write -= 4 * ngen
    per_line, per_gen = _MP_INDEX.get(name, (0, 0))
    parts = {"read": read * itemsize + (per_line * nline + per_gen * ngen)
             * 8 + (8 if scalar_tensor else 0),
             "write": write * itemsize}
    if name == "mp_ramp_pack":   # the uint8 flags
        parts["write"] += (T - 1) * ngen
    parts["total"] = parts["read"] + parts["write"]
    return parts


def mpacopf_hook_ops(name: str, T: int, ngen: int, nline: int, nbus: int,
                     nblocks: int = 0) -> int:
    """Operations of one launch of the multi-period hook kernel ``name``."""
    n = T * (2 * ngen + 8 * nline)
    units = (n, T * ngen, T * nline, (T - 1) * ngen, T * nbus,
             13 * T * nblocks, 1, T)
    return sum(a * b for a, b in zip(_MP_OPS[name], units))
