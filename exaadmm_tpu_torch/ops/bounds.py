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
