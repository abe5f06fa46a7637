"""A rehearsal of chip_smoke.py on the CPU, at case9 size.

On the CPU every wrapper runs its plain version, so the kernel comparisons
are trivially exact here; what this checks is the script's own paths,
shapes, thresholds and output, which the card run relies on."""

import json
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke
from exaadmm_tpu_torch.utils.opfdata import load_time_series, opf_loaddata

from .test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rehearsal_on_cpu(case9_path, capsys):
    data = opf_loaddata(case9_path, verbose=0)
    loads = load_time_series(chip_smoke.DEMAND9)
    res = chip_smoke.run("cpu", data, data, loads, 3)
    out = capsys.readouterr().out
    for phase in ("1", "1b", "2", "2b", "2c", "3", "3b", "3c", "4", "5", "6"):
        assert f"phase {phase}:" in out
    assert "phase 2: tron_alm_branch x 3 periods" in out
    assert "phase 2c: tron_alm_qpsub without line limits" in out
    assert "phase 3b: case9 x 1 period" in out
    assert "gens (3, 3, 4)" in out   # folded generator values, with ramp
    assert res["case9"]["outer"] == chip_smoke.PIN_OUTER
    assert res["case9"]["cumul"] == chip_smoke.PIN_CUMUL
    assert res["case9_mp"]["outer"] == chip_smoke.MP_PIN_OUTER
    assert res["case9_mp"]["cumul"] == chip_smoke.MP_PIN_CUMUL
    assert res["case9_qp"]["outer"] == chip_smoke.QP_PIN_ITERS
    assert res["case9_qp"]["cumul"] == chip_smoke.QP_PIN_ITERS
    assert abs(res["case9_qp"]["obj"] - chip_smoke.QP_PIN_OBJ) <= 1e-8
    assert res["main_qp"]["mismatch"] > 0.0
    assert set(res["qpsub"]) == {"f64", "f32", "f64_nolimit", "f32_nolimit"}
    names = [k["name"] for k in res["kernels"]]
    assert names == ["tron_alm_branch", "tron_alm_ramp", "tron_alm_qpsub",
                     "bus_scatter"]
    for k in res["kernels"]:
        assert set(k) == {"name", "route", "source", "replaces", "launches",
                          "max_abs_err", "ms", "plain_ms"}
        assert os.path.isfile(os.path.join(ROOT, k["source"]))
        path, line = k["replaces"].split(":")
        with open(os.path.join(ROOT, path)) as f:
            assert "def " in f.read().splitlines()[int(line) - 1]
    json.dumps(res["kernels"])


def test_script_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
