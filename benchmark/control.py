"""The readings that a cell's limits are set from: the program as the
configuration states it, the control (the same program in the nearest
precision below, ``--dtype float32`` for an fp64 configuration: the port's
own fp32 path) and planted faults (``FAULTS`` of the configuration model's
``requests/<model>.py``), each over the same requests of each seed.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \\
        --seconds 5 --dtype float32 --fault none c1_halved

Every reading comes from ``harness.run``, the path the benchmark's runs
take: set-up, a window of ``--seconds``, and the check of the window's
sampled answers. For each precision, fault and seed it prints one JSON
line: whether the run came out correct, its requests, and the reading of
every number the check compares. The benchmark's own runs never run it. It needs a
CUDA card unless ``--device cpu`` is given.
"""

import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)


def readings(bench, name, seeds, seconds, dtype, fault, device="cuda"):
    """One dict per seed: whether the run was correct, its requests and
    the check's worst reading of every number."""
    import torch

    from benchmark import harness, port

    _, config, _ = harness.resolve(bench, name)
    planted = None
    if fault != "none":
        faults = port.kinds(config["model"]).FAULTS
        if fault not in faults:
            raise ValueError(f"no fault {fault!r} for model "
                             f"{config['model']!r}; there are "
                             f"{sorted(faults)}")
        owner, attr, fn = faults[fault]()
        planted = (owner, attr, getattr(owner, attr))
        setattr(owner, attr, fn)
    out = []
    try:
        for seed in seeds:
            res = harness.run(bench, name, seed=seed, seconds=seconds,
                              traced=False, t_start=time.perf_counter(),
                              device=device, dtype=port.DTYPES[dtype])
            out.append(dict(workload=name, dtype=dtype, fault=fault,
                            seed=seed, correct=res["correct"],
                            attempted=res["attempted"],
                            failed=res["failed"], readings={
                                k: c["value"] for k, c in
                                res["check"].items()}))
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    finally:
        if planted:
            setattr(*planted)
    return out


def main(argv=None) -> int:
    import argparse

    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--dtype", nargs="+", default=["float64", "float32"])
    ap.add_argument("--fault", nargs="+", default=["none"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    for dt in args.dtype:
        for fault in args.fault:
            for line in readings(bench, args.workload, args.seeds,
                                 args.seconds, dt, fault, args.device):
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
