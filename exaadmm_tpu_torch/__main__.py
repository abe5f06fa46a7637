"""Command-line entry point: ``python -m exaadmm_tpu_torch <case.m> [options]``.

Counterpart of ``exaadmm_tpu/__main__.py``: the same solvers, the same flags
with the same defaults, the same summary keys and exit codes (0 Solved, 1
otherwise, 2 on a usage error).

    python -m exaadmm_tpu_torch data/case9.m --rho-pq 400 --rho-va 40000
    python -m exaadmm_tpu_torch case.m --solver mpacopf --load-prefix demand \\
        --end-period 3
    python -m exaadmm_tpu_torch case.m --mesh 4 --checkpoint sol.npz
    python -m exaadmm_tpu_torch case.m --device cpu --mesh 2

New here: ``--device`` (default ``cuda``; without a card the solve fails, as
the entry points do; there is no fallback). fp64 is the default on every
device (Hopper has native fp64); ``--fp32`` selects ``torch.float32``.
``--mixed-precision`` (an fp64 solve with the branch batch in fp32) cannot
be combined with ``--fp32``. The JAX CLI's ``--branch-backend`` and
``--bus-backend`` select TPU code paths the port does not have, and are
unknown flags here.

``--mesh N`` splits the lines over N ranks: it starts N local processes
(rank r on ``cuda:r``, or all on the CPU over gloo with ``--device cpu``);
rank 0 writes the checkpoint and its summary is printed. Under a launcher
that already set ``RANK`` and ``WORLD_SIZE`` (``torchrun``) it joins that
run and starts nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m exaadmm_tpu_torch",
        description="Two-level ADMM solver for ACOPF in PyTorch and CUDA "
                    "(capabilities of exanauts/ExaAdmm.jl)")
    p.add_argument("case", help="MATPOWER .m case file")
    p.add_argument("--solver", default="acopf",
                   choices=["acopf", "rolling", "mpacopf", "pf", "qpsub",
                            "mpec"])
    p.add_argument("--rho-pq", type=float, default=400.0)
    p.add_argument("--rho-va", type=float, default=40000.0)
    p.add_argument("--outer-iterlim", type=int, default=20)
    p.add_argument("--inner-iterlim", type=int, default=1000)
    p.add_argument("--outer-eps", type=float, default=2e-4)
    p.add_argument("--scale", type=float, default=1e-4,
                   help="branch objective scaling")
    p.add_argument("--obj-scale", type=float, default=1.0)
    p.add_argument("--tight-factor", type=float, default=1.0)
    p.add_argument("--no-linelimit", action="store_true")
    p.add_argument("--projection", action="store_true",
                   help="power-flow feasibility projection after the solve")
    p.add_argument("--device", default="cuda",
                   help="torch device of the solve (cuda, cuda:1, cpu); "
                        "cuda fails without a card")
    p.add_argument("--fp32", action="store_true", help="run in float32")
    p.add_argument("--fp64", action="store_true",
                   help="run in float64 (the default on every device)")
    p.add_argument("--tron-step-cap", type=int, default=None,
                   help="lockstep trust-region step budget per branch solve")
    p.add_argument("--mixed-precision", action="store_true",
                   help="fp64 solve with the branch batch in fp32; "
                        "consensus/residual stay fp64")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="split the lines over N ranks (local processes, or "
                        "the launcher's when RANK/WORLD_SIZE are set)")
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="write the final solution (npz) here")
    p.add_argument("--json", action="store_true",
                   help="print the result summary as one JSON line")
    # rolling / multi-period
    p.add_argument("--load-prefix", default=None,
                   help="path prefix of the {prefix}.Pd/.Qd time series")
    p.add_argument("--start-period", type=int, default=1)
    p.add_argument("--end-period", type=int, default=1)
    p.add_argument("--ramp-ratio", type=float, default=0.02)
    # qpsub (SQP inner QP)
    p.add_argument("--qp-inputs", default=None, metavar="NPZ",
                   help="npz with the SQP QP arrays (Hs, LH_1h, ... Pd, Qd); "
                        "omitted: linearize about the NR power-flow point")
    p.add_argument("--initial-beta", type=float, default=1e5)
    # mpec (primary control + storage complementarity)
    p.add_argument("--storage-ratio", type=float, default=0.0)
    p.add_argument("--droop", type=float, default=0.04)
    return p


def _solve(mesh, device, args):
    """Run the solver ``args`` names; returns (exit code, summary dict).
    With a mesh every rank calls this (it is what ``spawn_ranks`` starts);
    rank 0 writes the checkpoint."""
    import numpy as np
    import torch

    import exaadmm_tpu_torch as X

    dtype = torch.float32 if args.fp32 else torch.float64
    common = dict(
        rho_pq=args.rho_pq, rho_va=args.rho_va,
        outer_iterlim=args.outer_iterlim, inner_iterlim=args.inner_iterlim,
        outer_eps=args.outer_eps, scale=args.scale, obj_scale=args.obj_scale,
        tight_factor=args.tight_factor,
        use_linelimit=not args.no_linelimit,
        verbose=args.verbose, dtype=dtype, device=device,
    )

    if args.solver == "acopf":
        res = X.solve_acopf(args.case, use_projection=args.projection,
                            mesh=mesh, tron_step_cap=args.tron_step_cap,
                            mixed_precision=args.mixed_precision, **common)
    elif args.solver == "rolling":
        res, _infos = X.solve_acopf_rolling(
            args.case, args.load_prefix,
            start_period=args.start_period, end_period=args.end_period,
            ramp_ratio=args.ramp_ratio, **common)
    elif args.solver == "mpacopf":
        res = X.solve_mpacopf(
            args.case, args.load_prefix,
            start_period=args.start_period, end_period=args.end_period,
            ramp_ratio=args.ramp_ratio, **common)
    elif args.solver == "qpsub":
        from exaadmm_tpu_torch.models.qpsub.model import QP_KEYS
        if args.qp_inputs:
            qp = dict(np.load(args.qp_inputs))
        else:
            # one SQP linearization about the power-flow warm-start point
            from exaadmm_tpu_torch.models.qpsub.sqp import (SqpBasePoint,
                                                            build_qp_inputs)
            from exaadmm_tpu_torch.utils.grid_data import build_grid_data
            data = X.opf_loaddata(args.case, verbose=args.verbose)
            gd = build_grid_data(data, tight_factor=args.tight_factor)
            base = SqpBasePoint.from_power_flow(data, verbose=args.verbose)
            qp = build_qp_inputs(data, gd, base)
        res = X.solve_qpsub(args.case, *[qp[k] for k in QP_KEYS],
                            args.initial_beta, mesh=mesh, **common)
    elif args.solver == "mpec":
        res = X.solve_acopf_mpec(
            args.case, storage_ratio=args.storage_ratio, droop=args.droop,
            mesh=mesh, **common)
    else:  # pf
        pf = X.solve_pf(args.case, verbose=args.verbose)
        return (0 if pf.converged else 1,
                {"solver": "pf", "converged": bool(pf.converged),
                 "iters": int(pf.iterations),
                 "residual": float(pf.residual)})

    info = res.info
    summary = {
        "solver": args.solver,
        "case": args.case,
        "status": info.status,
        "objval": info.objval,
        "outer": info.outer,
        "cumul": info.cumul,
        "primres": info.primres,
        "dualres": info.dualres,
        "mismatch": info.mismatch,
        "time_overall_s": round(info.time_overall, 4),
    }
    if args.checkpoint:
        if mesh is None or mesh.rank == 0:
            X.save_solution(args.checkpoint, res.solution,
                            meta={"case": args.case, "outer": info.outer,
                                  "objval": info.objval})
        summary["checkpoint"] = args.checkpoint
    return (0 if info.status == "Solved" else 1), summary


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.fp32 and args.fp64:
        print("--fp32 and --fp64 are mutually exclusive", file=sys.stderr)
        return 2
    if args.mixed_precision and args.fp32:
        print("--mixed-precision needs the fp64 state (it casts only the "
              "branch batch down); drop --fp32", file=sys.stderr)
        return 2
    if args.solver in ("rolling", "mpacopf") and not args.load_prefix:
        print(f"--load-prefix is required for --solver {args.solver}",
              file=sys.stderr)
        return 2
    if args.mesh > 0 and args.solver not in ("acopf", "qpsub", "mpec"):
        print(f"--mesh is not available for --solver {args.solver}",
              file=sys.stderr)
        return 2

    if args.mesh <= 0:
        rc, summary = _solve(None, args.device, args)
        rank = 0
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # under a launcher: join its run, start nothing
        from exaadmm_tpu_torch.parallel import distributed
        rank = int(os.environ["RANK"])
        device = distributed.rank_device(
            args.device, int(os.environ.get("LOCAL_RANK", rank)))
        mesh = distributed.initialize_and_make_mesh(device=device)
        try:
            if mesh.size != args.mesh:
                print(f"--mesh {args.mesh} under a launcher of {mesh.size} "
                      "ranks", file=sys.stderr)
                return 2
            rc, summary = _solve(mesh, device, args)
        finally:
            distributed.shutdown()
    else:
        from exaadmm_tpu_torch.parallel import distributed
        # the ranks unpickle their function by module name, and run as
        # ``python -m`` this module's name is ``__main__``: take the
        # function from the module under its importable name
        from exaadmm_tpu_torch.__main__ import _solve as rank_fn
        rc, summary = distributed.spawn_ranks(
            rank_fn, (args,), nprocs=args.mesh, device=args.device,
            timeout=600.0, join_timeout=7 * 24 * 3600.0)
        rank = 0

    if rank == 0:
        if args.json or args.solver == "pf":
            print(json.dumps(summary))
        else:
            for k, v in summary.items():
                print(f"{k:16s} {v}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
