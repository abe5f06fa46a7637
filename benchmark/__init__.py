"""The benchmark of ``exaadmm_tpu_torch`` on NVIDIA H100 cards: cells of
ACOPF requests (``BENCHMARK.json``), run by ``run.py``."""

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(folder: str, name: str):
    """The module ``<folder>/<name>.py`` under the benchmark, loaded from its
    file: how the harness finds what belongs to one configuration or
    metric by the name that names it."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
