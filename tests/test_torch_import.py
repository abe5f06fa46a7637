"""The port stands alone: it imports neither jax nor the JAX package, and it
never quietly falls back to the CPU when CUDA is asked for."""

import os
import subprocess
import sys

import pytest
import torch

import exaadmm_tpu_torch
from exaadmm_tpu_torch.ops import bus_cuda, tron_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import exaadmm_tpu_torch
for m in pkgutil.walk_packages(exaadmm_tpu_torch.__path__, "exaadmm_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n.startswith("jaxlib.") or n == "exaadmm_tpu"
             or n.startswith("exaadmm_tpu."))
print("BAD", bad)
print("COUNT", sum(n.startswith("exaadmm_tpu_torch") for n in sys.modules))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(ln.split(" ", 1) for ln in out.stdout.splitlines())
    assert lines["BAD"] == "[]"
    assert int(lines["COUNT"]) >= 15


def test_cuda_device_without_cuda_raises(case9_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exaadmm_tpu_torch.solve_acopf(case9_path, verbose=0, device="cuda")


def test_wrappers_refuse_other_devices():
    vals = torch.zeros((4, 8), device="meta")
    ids = torch.zeros(4, dtype=torch.int64, device="meta")
    ptr = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bus_cuda.bus_scatter(vals, ids, ptr, ptr)
    x = torch.zeros((6, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tron_cuda.tron_alm_branch(x, x, x, {}, x[:2], x[0], gtol=1e-6,
                                  frtol=1e-12, ctol=1e-6, mu_max=1e8,
                                  max_minor=200, max_auglag=50)


def test_cpu_wrappers_launch_no_kernel(case9_path):
    bus_cuda.launches = tron_cuda.launches = 0
    exaadmm_tpu_torch.solve_acopf(case9_path, outer_iterlim=1,
                                  inner_iterlim=2, verbose=0)
    assert bus_cuda.launches == 0 and tron_cuda.launches == 0
