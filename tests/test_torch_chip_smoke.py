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
from exaadmm_tpu_torch.utils.opfdata import opf_loaddata

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rehearsal_on_cpu(case9_path, capsys):
    res = chip_smoke.run("cpu", opf_loaddata(case9_path, verbose=0))
    out = capsys.readouterr().out
    for phase in range(1, 5):
        assert f"phase {phase}:" in out
    assert res["case9"]["outer"] == chip_smoke.PIN_OUTER
    assert res["case9"]["cumul"] == chip_smoke.PIN_CUMUL
    names = [k["name"] for k in res["kernels"]]
    assert names == ["tron_alm_branch", "bus_scatter"]
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
