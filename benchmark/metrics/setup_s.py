"""Seconds from the process's start to the first request of the window:
imports, the card, the kernel libraries (built on a checkout's first run,
loaded from ``build/`` after), the grid, and the warm-up request."""


def read(run):
    return run.setup_s
