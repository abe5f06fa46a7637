"""Entry points: per request, the harness's wall time of the call less the
device-resident loops' own time (``info.time_overall`` of every fused
solve it made, launch to read-back), the mean over the window's requests:
model build, graph build, initialisation, uploads and the result."""


def read(run):
    if not run.requests or not all(r["solves"] for r in run.requests):
        return None
    outside = [r["seconds"] - sum(s["time_overall"] for s in r["solves"])
               for r in run.requests]
    return 1e3 * sum(outside) / len(outside)
