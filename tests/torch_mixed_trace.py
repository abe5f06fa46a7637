"""Per-outer trace of a mixed-precision ACOPF solve, in the port and,
optionally, in the JAX package.

A mixed solve (``mixed_precision=True``: an fp32 branch batch inside an
fp64 solve) ends when the outer mismatch falls to ``outer_tol``; near its
fp32 noise floor the last outer iterations decide on a few per cent. This
script prints, for each package and each case asked for, the status, the
counts and the objective, and per outer iteration the driver's own verbose
line (primres, eps_pri, mismatch, outer_tol, beta), so the two packages'
approach to the tolerance can be laid side by side.

    python -m tests.torch_mixed_trace [--device cpu|cuda]
        [--packages torch,jax] [--outer-eps 2e-5] [--outer-iterlim 30]
        [--cases case9,case9:nolimit] [--precision mixed,fp64] [--out FILE]

``--packages`` names the packages to run, the port (``torch``, on
``--device``) by default; ``jax`` runs the JAX package on the CPU (fp64
enabled). Without ``jax`` the script imports no JAX, so it runs on a
machine that has none. A case is a
file under ``data/`` (``case9``, ``case9_pglib``), with ``:nolimit`` for
the solve without line limits. Each run prints one JSON line, and ``--out``
collects them in a file.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the driver's verbose columns (both packages print the same line)
COLUMNS = ("outer", "inner", "objval", "auglag", "primres", "eps_pri",
           "dualres", "norm_z", "mismatch", "outer_tol", "beta")


def _parse(text: str) -> list:
    rows = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) != len(COLUMNS) or not parts[0].isdigit():
            continue
        rows.append({k: (int(v) if k in ("outer", "inner") else float(v))
                     for k, v in zip(COLUMNS, parts)})
    return rows


def run(package: str, case: str, precision: str, device: str, kw: dict):
    """One solve with the verbose trace captured: a dict of its outcome."""
    kw = dict(kw, use_linelimit=not case.endswith(":nolimit"),
              mixed_precision=precision == "mixed", verbose=1)
    path = os.path.join(ROOT, "data", case.split(":")[0] + ".m")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        if package == "jax":
            import exaadmm_tpu
            res = exaadmm_tpu.solve_acopf(path, **kw)
        else:
            import exaadmm_tpu_torch
            res = exaadmm_tpu_torch.solve_acopf(path, device=device, **kw)
    secs = time.perf_counter() - t0
    info = res.info
    rows = _parse(buf.getvalue())
    last = rows[-1] if rows else {}
    return dict(package=package, device=device if package == "torch"
                else "cpu", case=case, precision=precision,
                outer_eps=kw["outer_eps"], status=info.status,
                outer=info.outer, cumul=info.cumul, objval=info.objval,
                seconds=secs,
                last_ratio=(last["mismatch"] / last["outer_tol"]
                            if last else None),
                trace=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--packages", default="torch")
    ap.add_argument("--outer-eps", type=float, default=2e-5)
    ap.add_argument("--outer-iterlim", type=int, default=30)
    ap.add_argument("--cases", default="case9")
    ap.add_argument("--precision", default="mixed")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    packages = args.packages.split(",")
    if "jax" in packages:
        import jax
        jax.config.update("jax_enable_x64", True)
        jax.config.update("jax_platforms", "cpu")
    kw = dict(rho_pq=4e2, rho_va=4e4, outer_eps=args.outer_eps,
              outer_iterlim=args.outer_iterlim)
    out = open(args.out, "w") if args.out else None
    try:
        for case in args.cases.split(","):
            for precision in args.precision.split(","):
                for package in packages:
                    r = run(package, case, precision, args.device, kw)
                    line = json.dumps(r)
                    print(line, flush=True)
                    if out:
                        out.write(line + "\n")
                        out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
