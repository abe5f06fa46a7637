"""The benchmark of ``exaadmm_tpu_torch`` on NVIDIA H100 cards: cells of
ACOPF requests (``BENCHMARK.json``), run by ``run.py``."""
