"""Fused driver: inner iterations of every solve of the window per period
answered: how fast the solver converges, an exact count."""


def read(run):
    periods = sum(r["periods"] for r in run.requests)
    solves = [s for r in run.requests for s in r["solves"]]
    if not periods or not solves:
        return None
    return sum(s["cumul"] for s in solves) / periods
