"""End-of-solve summary (reference src/utils/print_statistics.jl:1-21).

Counterpart of ``exaadmm_tpu/utils/print_statistics.py``, over the fields
the port's ``IterationInformation`` keeps: the per-hook wall times are
printed when a solve filled them (``Parameters.time_hooks``); it has no
two-pass branch counters."""

from __future__ import annotations

from .environment import IterationInformation


def print_statistics(info: IterationInformation, extra: dict | None = None):
    print(" ** Summary")
    print(f"Status  . . . . . . . . . . . . . {info.status}")
    print(f"Objective . . . . . . . . . . . . {info.objval:.6e}")
    print(f"Residual (||Ax+By||)  . . . . . . {info.mismatch:.6e}")
    print(f"Outer iterations  . . . . . . . . {info.outer}")
    print(f"Cumulative iterations . . . . . . {info.cumul}")
    if info.cumul > 0:
        print(f"Time per iteration (secs) . . . . "
              f"{info.time_overall / info.cumul:.4f}")
    print(f"Total time (secs) . . . . . . . . {info.time_overall:.2f}")
    t_hooks = (info.time_x_update + info.time_xbar_update
               + info.time_z_update + info.time_l_update
               + info.time_lz_update)
    if t_hooks > 0.0:
        print(f"Update x time (secs)  . . . . . . {info.time_x_update:.2f}")
        print(f"Update xbar time (secs) . . . . . {info.time_xbar_update:.2f}")
        print(f"Update z time (secs)  . . . . . . {info.time_z_update:.2f}")
        print(f"Update l time (secs)  . . . . . . {info.time_l_update:.2f}")
        print(f"Update lz time (secs) . . . . . . {info.time_lz_update:.2f}")
    if info.time_projection > 0.0:
        print(f"Projection time (secs)  . . . . . {info.time_projection:.2f}")
    if info.pf_residual is not None:
        print(f"Power-flow residual . . . . . . . {info.pf_residual:.3e}")
    if info.max_cviol > 0.0:
        print(f"Max line-limit violation  . . . . {info.max_cviol:.3e}")
    for k, v in (extra or {}).items():
        print(f"{k:<34}{v}")
