"""Kernels: share of the roofline of the iteration's closed-form work.

The least time is the bytes that work must move (``roofline.py``: the
generator step, the branch pack, unpack and stats, the bus consensus, z,
l, the residual; lz once an outer round; each byte once, from the shapes)
over the HBM rate, for every inner iteration of the traced slice's solves.
It is divided by the device time of every activity of the slice that is
not a TRON/ALM kernel and not a copy to or from the host (profiler). The
count follows the work and not kernel names."""

from benchmark import roofline, trace


def read(run):
    if run.trace is None or not run.slice_solves:
        return None
    least = 0.0
    for s in run.slice_solves:
        per_it, lz = roofline.closed_form_bytes(
            s["ngen"], s["nline"], s["nbus"], s["itemsize"])
        least += ((s["cumul"] + s["built"]) * per_it
                  + (s["outer"] + s["built"]) * lz)
    ns = sum(e - s for s, e, name, _ in run.trace.slice_ops()
             if not trace.is_tron(name)
             and "HtoD" not in name and "DtoH" not in name)
    if not ns:
        return None
    return 100.0 * least / roofline.HBM_BYTES_PER_S / (ns * 1e-9)
