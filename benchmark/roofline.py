"""The least bytes of the ADMM iteration's closed-form work, and the card's
published bandwidth: the benchmark's own copy of the byte formulas of the
port's ``exaadmm_tpu_torch/ops/bounds.py`` for a single-period solve with
line limits, frozen here.

The closed-form work is everything an inner iteration does besides the
TRON/ALM solve of the line subproblems: the generator step, the branch
batch's pack, unpack and stats, the bus consensus (its values, the two CSR
sums, the per-bus solve, the writeback), z, l, the residual, and lz once an
outer round. Its bytes come from the shapes alone, each input read once and
each output written once, summed over that work as the port divides it
today (``closed_form_bytes``). The count follows the work and not the
kernels' names, so kernels that a later change fuses leave it as it is.

Bandwidth: NVIDIA's data sheet for the H100 SXM (80 GB HBM3 at 3.35 TB/s),
at its 700 W power limit; a card set to a lower limit reaches less, so the
harness reports the limit beside every result.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
#: the residual kernels' block size, which sets how many block sums they keep
THREADS = 256

# the ACOPF hook kernels (``csrc/acopf_hooks.cu``): per kernel, the values
# read and written as multiples of (N, the elements of one ADMM vector,
# 2 ngen + 8 nline; ngen; nline; nbus; the residual's blocks), by hand from
# the source: the bytes each input and output must move once. The
# writeback reads columns 0-3 of the line blocks only and, besides, 2
# int64 indices a line and 1 a generator.
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
_PER_IT = ("acopf_generator", "acopf_bus_values", "acopf_bus_solve",
           "acopf_bus_writeback", "acopf_z", "acopf_l",
           "acopf_residual_partials", "acopf_residual_final")


def hook_bytes(name: str, ngen: int, nline: int, nbus: int, itemsize: int,
               nblocks: int = 0) -> int:
    """Bytes of one launch of the hook kernel ``name`` on ``ngen``
    generators, ``nline`` (padded) lines and ``nbus`` buses; ``nblocks``
    the residual's blocks."""
    units = (2 * ngen + 8 * nline, ngen, nline, nbus, nblocks)
    values = sum(sum(a * b for a, b in zip(c, units))
                 for c in _HOOK_VALUES[name])
    index = 2 * nline + ngen if name == "acopf_bus_writeback" else 0
    return values * itemsize + index * 8


def scatter_bytes(nrows: int, nseg: int, nch: int, itemsize: int) -> int:
    """Bytes of one bus scatter of (nrows, nch) values into nseg segments:
    the values, the int32 CSR (idx over the rows, ptr of nseg + 1) and the
    (nseg, nch) output."""
    return (nrows + nseg) * nch * itemsize + (nrows + nseg + 1) * 4


def branch_io_bytes(B: int, itemsize: int) -> int:
    """Bytes of the branch pack, unpack and stats kernels (``csrc/
    branch_io.cu``) over B lanes of the line-limit batch (n = 6), by hand
    from the source. The pack reads u, v, z, l, rho (32 values), lam1,
    lam2, mu, the 8 admittances, 4 bound pairs, rate_a and the mask (61)
    and writes x0, xl, xu, the 33 parameter rows, lam0, mu0 (54) and a
    flag byte; the unpack reads the 8 admittances, the mask, x's rows 0-3
    and cviol (14 values) and two int32 counts and the flag (9 bytes), and
    writes the new row (8) and the lane steps (4 bytes), and (3, nblocks)
    stats partials, which the stats kernel reads to write 5 values."""
    nb = -(-B // 256)
    pack = B * (115 * itemsize + 1)
    unpack = B * (22 * itemsize + 13) + 3 * nb * itemsize
    stats = (3 * nb + 5) * itemsize
    return pack + unpack + stats


def closed_form_bytes(ngen: int, nline: int, nbus: int, itemsize: int = 8
                      ) -> tuple[float, float]:
    """(bytes of one inner iteration, bytes of one outer round's lz) of the
    closed-form work of a single-period solve with line limits on a grid of
    ``ngen`` generators, ``nline`` (padded) lines and ``nbus`` buses."""
    nb = -(-(2 * ngen + 8 * nline) // THREADS)
    per_it = sum(hook_bytes(h, ngen, nline, nbus, itemsize, nb)
                 for h in _PER_IT)
    per_it += scatter_bytes(2 * nline, nbus, 8, itemsize)
    per_it += scatter_bytes(ngen, nbus, 4, itemsize)
    per_it += branch_io_bytes(nline, itemsize)
    lz = hook_bytes("acopf_lz", ngen, nline, nbus, itemsize)
    return float(per_it), float(lz)
