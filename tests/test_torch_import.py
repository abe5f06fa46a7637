"""The port stands alone: it imports neither jax nor the JAX package, and it
never quietly falls back to the CPU when CUDA is asked for."""

import os
import subprocess
import sys

import pytest
import torch

import exaadmm_tpu_torch
from exaadmm_tpu_torch.ops import bus_cuda, tron_cuda

from .test_torch_threads import one_torch_thread  # noqa: F401

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
    # every module of the package, the multi-period and qpsub ones included
    assert int(lines["COUNT"]) >= 30


def test_cuda_device_without_cuda_raises(case9_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exaadmm_tpu_torch.solve_acopf(case9_path, verbose=0, device="cuda")


def _default_device_call(name, case9_path):
    """A call of entry point ``name`` that leaves ``device`` to its
    default."""
    if name == "solve_acopf":
        return lambda: exaadmm_tpu_torch.solve_acopf(case9_path, verbose=0)
    if name == "solve_mpacopf":
        return lambda: exaadmm_tpu_torch.solve_mpacopf(
            case9_path, os.path.join(ROOT, "data", "case9_demand"),
            end_period=2, verbose=0)
    from exaadmm_tpu_torch.models.qpsub.model import QP_KEYS
    from exaadmm_tpu_torch.models.qpsub.sqp import (SqpBasePoint,
                                                    build_qp_inputs)
    from exaadmm_tpu_torch.utils.grid_data import build_grid_data
    from exaadmm_tpu_torch.utils.opfdata import opf_loaddata
    data = opf_loaddata(case9_path, verbose=0)
    qp = build_qp_inputs(data, build_grid_data(data), SqpBasePoint(
        pg=data.Pg0, qg=data.Qg0, vm=data.Vm, va=data.Va))
    return lambda: exaadmm_tpu_torch.solve_qpsub(
        case9_path, *[qp[k] for k in QP_KEYS], verbose=0)


@pytest.mark.parametrize("name", ["solve_acopf", "solve_mpacopf",
                                  "solve_qpsub"])
def test_entry_points_default_to_cuda(name, case9_path):
    """With no ``device`` an entry point asks for the card, so without one
    it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    call = _default_device_call(name, case9_path)
    with pytest.raises(RuntimeError, match="device='cuda' asked for"):
        call()


def test_wrappers_refuse_other_devices():
    vals = torch.zeros((4, 8), device="meta")
    ids = torch.zeros(4, dtype=torch.int64, device="meta")
    ptr = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bus_cuda.bus_scatter(vals, ids, ptr, ptr)
    x = torch.zeros((6, 4), device="meta")
    opts = dict(gtol=1e-6, frtol=1e-12, ctol=1e-6, mu_max=1e8, max_minor=200,
                max_auglag=50)
    with pytest.raises(ValueError, match="unsupported device"):
        tron_cuda.tron_alm_branch(x, x, x, {}, x[:2], x[0], **opts)
    with pytest.raises(ValueError, match="unsupported device"):
        tron_cuda.tron_alm_ramp(x[:3], x[:3], x[:3], {}, x[:1], x[0], **opts)
    with pytest.raises(ValueError, match="unsupported device"):
        tron_cuda.tron_alm_qpsub(x, x, x, {}, x[:2], x[0], **opts)


def test_cpu_wrappers_launch_no_kernel(case9_path):
    from exaadmm_tpu_torch.models.qpsub.model import QP_KEYS
    from exaadmm_tpu_torch.models.qpsub.sqp import (SqpBasePoint,
                                                    build_qp_inputs)
    from exaadmm_tpu_torch.utils.grid_data import build_grid_data
    from exaadmm_tpu_torch.utils.opfdata import opf_loaddata

    bus_cuda.launches = tron_cuda.launches = tron_cuda.ramp_launches = 0
    tron_cuda.qpsub_launches = 0
    exaadmm_tpu_torch.solve_acopf(case9_path, outer_iterlim=1,
                                  inner_iterlim=2, verbose=0, device="cpu")
    exaadmm_tpu_torch.solve_mpacopf(
        case9_path, os.path.join(ROOT, "data", "case9_demand"), end_period=2,
        outer_iterlim=1, inner_iterlim=2, warm_start=False, verbose=0,
        device="cpu")
    data = opf_loaddata(case9_path, verbose=0)
    qp = build_qp_inputs(data, build_grid_data(data), SqpBasePoint(
        pg=data.Pg0, qg=data.Qg0, vm=data.Vm, va=data.Va))
    exaadmm_tpu_torch.solve_qpsub(case9_path, *[qp[k] for k in QP_KEYS],
                                  outer_iterlim=2, verbose=0, device="cpu")
    assert bus_cuda.launches == 0 and tron_cuda.launches == 0
    assert tron_cuda.ramp_launches == 0 and tron_cuda.qpsub_launches == 0
