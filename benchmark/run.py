"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json``. The run needs as
many CUDA cards as the cell asks for and fails without them; it never
falls back to the CPU. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``check``: each compared number with
its limit); the compared numbers are also the last lines of standard
error. The kernel libraries build into ``build/`` inside the checkout on
the first run and load from there afterwards.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# the checkout's root, so that the benchmark and the port import as packages
sys.path[0] = str(REPO)
# fixed cache directories inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "build/triton"),
                 ("TORCH_EXTENSIONS_DIR", "build/torch_extensions")):
    os.environ[var] = str(REPO / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    bench = harness.load_benchmark()
    cell, _, _ = harness.resolve(bench, args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"machine has {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run(bench, args.workload, seed=args.seed,
                         seconds=args.seconds, traced=bool(args.trace),
                         t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process holds {bad} after the window", file=sys.stderr)
        return 1
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
