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
    # every module of the package, the multi-period, qpsub, MPEC and power
    # flow ones included
    assert int(lines["COUNT"]) >= 38


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
    if name == "solve_acopf_mpec":
        return lambda: exaadmm_tpu_torch.solve_acopf_mpec(case9_path,
                                                          verbose=0)
    if name == "solve_acopf_rolling":
        return lambda: exaadmm_tpu_torch.solve_acopf_rolling(
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
                                  "solve_qpsub", "solve_acopf_mpec",
                                  "solve_acopf_rolling"])
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
    with pytest.raises(ValueError, match="unsupported device"):
        tron_cuda.tron_alm_polar(x[:4], x[:4], x[:4], {}, x[:0], x[0],
                                 **opts)


def test_cpu_wrappers_launch_no_kernel(case9_path):
    from exaadmm_tpu_torch.models.qpsub.model import QP_KEYS
    from exaadmm_tpu_torch.models.qpsub.sqp import (SqpBasePoint,
                                                    build_qp_inputs)
    from exaadmm_tpu_torch.utils.grid_data import build_grid_data
    from exaadmm_tpu_torch.utils.opfdata import opf_loaddata

    bus_cuda.launches = 0
    tron_cuda.launches.clear()
    exaadmm_tpu_torch.solve_acopf(case9_path, outer_iterlim=1,
                                  inner_iterlim=2, verbose=0, device="cpu")
    exaadmm_tpu_torch.solve_acopf(case9_path, outer_iterlim=1,
                                  inner_iterlim=2, use_linelimit=False,
                                  verbose=0, device="cpu")
    exaadmm_tpu_torch.solve_acopf_mpec(case9_path, outer_iterlim=1,
                                       inner_iterlim=2, storage_ratio=0.3,
                                       verbose=0, device="cpu")
    exaadmm_tpu_torch.solve_mpacopf(
        case9_path, os.path.join(ROOT, "data", "case9_demand"), end_period=2,
        outer_iterlim=1, inner_iterlim=2, warm_start=False, verbose=0,
        device="cpu")
    data = opf_loaddata(case9_path, verbose=0)
    qp = build_qp_inputs(data, build_grid_data(data), SqpBasePoint(
        pg=data.Pg0, qg=data.Qg0, vm=data.Vm, va=data.Va))
    exaadmm_tpu_torch.solve_qpsub(case9_path, *[qp[k] for k in QP_KEYS],
                                  outer_iterlim=2, verbose=0, device="cpu")
    assert bus_cuda.launches == 0 and tron_cuda.launches == {}
    assert all(tron_cuda.instance_launches(inst) == 0
               for inst in (tron_cuda.BRANCH, tron_cuda.RAMP,
                            tron_cuda.QPSUB, tron_cuda.POLAR))


def test_options_match_the_jax_package():
    """The options of ``Parameters``, ``solve_acopf`` and ``build_model`` in
    the two packages. The JAX-only names are exactly ROADMAP's "Do not
    port" list (TPU code paths, the from-bus order that XLA's sorted
    scatter wants, and tolerances no solve reads); the
    port-only names are ``time_hooks``, ``device`` and ``data``. A new
    option in either package fails this test until the other has it or
    the lists here (and ROADMAP's) say why not."""
    import dataclasses
    import inspect

    import exaadmm_tpu
    from exaadmm_tpu.models.acopf import model as JM
    from exaadmm_tpu_torch.models.acopf import model as TM

    def names(f):
        return set(inspect.signature(f).parameters)

    ours = {f.name for f in dataclasses.fields(exaadmm_tpu_torch.Parameters)}
    theirs = {f.name for f in dataclasses.fields(exaadmm_tpu.Parameters)}
    jax_only = {
        "Parameters": theirs - ours,
        "solve_acopf": (names(exaadmm_tpu.solve_acopf)
                        - names(exaadmm_tpu_torch.solve_acopf)),
        "build_model": names(JM.build_model) - names(TM.build_model),
    }
    assert jax_only == {
        "Parameters": {"branch_two_pass", "branch_pass1_cap",
                       "branch_tail_tiles", "pallas_pass1_tile",
                       "tron_trial_unroll", "branch_backend", "pallas_tile",
                       "bus_backend", "ABSTOL", "RELTOL", "DUAL_TOL"},
        "solve_acopf": {"branch_backend", "pallas_tile", "bus_backend",
                        "backend"},
        "build_model": {"sort_lines_static"},
    }
    assert ours - theirs == {"time_hooks"}
    assert (names(exaadmm_tpu_torch.solve_acopf)
            - names(exaadmm_tpu.solve_acopf)) == {"device", "data"}
    assert names(TM.build_model) - names(JM.build_model) == {"device"}
    for f in ("sort_lines", "mixed_precision"):
        assert (getattr(exaadmm_tpu_torch.Parameters(), f)
                == getattr(exaadmm_tpu.Parameters(), f) is False)
