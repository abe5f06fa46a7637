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
    res = chip_smoke.run("cpu", data, data, loads, 3, case118_outer=2,
                         case9_mixed_outer=2, case9_fused_outer=2,
                         qp_fused_iters=40)
    out = capsys.readouterr().out
    for phase in ("1", "1b", "1c", "2", "2b", "2c", "2d", "2f", "3", "3b",
                  "3c", "3d", "3e", "3f", "3g", "3h", "4h", "4", "5", "5h",
                  "6",
                  "7", "8", "9a", "9b", "10a", "10b", "11"):
        assert f"phase {phase}:" in out
    # the hook kernels against their plain versions (trivially exact on the
    # CPU, where the wrappers run the plain versions), the residual's tree
    # against torch.sum, the hooks eager and in a graph
    assert set(res["hooks"]) == set(chip_smoke.HOOK_KERNELS) | {
        "hooks", "floor_ms"}
    assert set(res["hooks"]["hooks"]) == {"x (generator)", "xbar", "z",
                                          "l", "lz", "residual"}
    assert "acopf_z f32: bit-identical" in out
    assert res["hooks"]["acopf_residual_final"]["max_abs_err"] == 0.0
    # the branch update's pack, unpack and stats against their plain
    # versions: 19 batches (types, instances, iterations, the periods'
    # batch, a random line order, the rank windows)
    assert res["branch_io"]["cases"] == 19
    assert set(res["branch_io"]) == set(chip_smoke.BRANCH_IO_KERNELS) | {
        "io", "cases", "census"}
    assert "in a random line order: B=32 (23 inactive)" in out
    assert "x 3 periods mixed line limits: B=27" in out
    assert "rank 1 of 2: B=5 (1 inactive)" in out
    # the multi-period hook kernels against their plain versions on 7
    # batches (fp64 with inner_iter a tensor and an int, fp32, case9 x 3,
    # case9 x 1, two rank windows), each hook eager and in a graph
    assert set(res["mp_hooks"]) == set(chip_smoke.MP_HOOK_KERNELS) | {
        "errs", "cases", "hooks", "floor_ms"}
    assert res["mp_hooks"]["cases"] == 7
    assert set(res["mp_hooks"]["hooks"]) == {"x (ramp pack, unpack)", "xbar",
                                             "z", "l", "lz", "residual"}
    assert "x 3 rank 1 of 2: T=3, 3 gens, 5 lines: 12 kernels" in out
    assert "case9 x 1: T=1, 3 gens, 9 lines: 11 kernels" in out
    assert res["mp_hooks"]["mp_residual_final"]["max_abs_err"] == 0.0
    # mixed precision and line sorting at phase 4's configuration
    assert res["main_mixed"]["outer"] == res["main"]["outer"]
    assert ((res["main_sorted"]["outer"], res["main_sorted"]["cumul"])
            == (res["main"]["outer"], res["main"]["cumul"]))
    assert res["sort"]["scatter_rel"] <= 1e-13
    assert "2 sorted rounds" in out
    # 10b's sorted solve and 9a's mesh solve ran the fused driver, each
    # held bit-identical to its host loop in the phase
    assert "solution tensors bit-identical: True" in out
    assert res["main_sorted"]["pre_ms"] > 0.0
    assert res["main_sorted"]["rate_host"] > 0.0
    assert set(res["mixed"]) == {"kernel", "polar_kernel", "main",
                                 "with line limits", "without line limits"}
    assert set(res["sort"]["it1_periods"]) == {"ms", "ms_sorted"}
    # case118 at a cut depth, the checkpoint, and the mesh paths: one rank
    # (gloo here) bit-equal to phase 4, two ranks on the same counts
    assert res["case118"]["outer"] == 2
    assert res["checkpoint"]["leaves"] == 21
    assert 5296.0 <= res["checkpoint"]["obj"] <= 5304.5
    assert "over a mesh of 1 rank (gloo)" in out
    assert res["main_mesh1"]["obj"] == res["main"]["obj"]
    assert res["main_mesh1"]["per_it"] == 4.0
    assert res["main_mesh1"]["bytes_per_it"] == 8 * (9 * 8 + 7 + 2 + 1)
    assert res["main_mesh1"]["rate_host"] > 0.0
    assert res["main_2ranks"]["cumul"] == res["main"]["cumul"]
    assert res["main_2ranks"]["case9"]["cumul"] == 315
    assert "gens (3, 6), storage (1, 2)" in out   # the MPEC bus sums
    assert "phase 2: tron_alm_branch x 3 periods" in out
    assert "phase 2c: tron_alm_qpsub without line limits" in out
    assert "phase 3b: case9 x 1 period" in out
    assert "gens (3, 3, 4)" in out   # folded generator values, with ramp
    assert res["case9"]["outer"] == chip_smoke.PIN_OUTER
    assert res["case9"]["cumul"] == chip_smoke.PIN_CUMUL
    assert res["case9_mp"]["outer"] == chip_smoke.MP_PIN_OUTER
    assert res["case9_mp"]["cumul"] == chip_smoke.MP_PIN_CUMUL
    assert (res["case9_polar"]["outer"], res["case9_polar"]["cumul"]) == (
        chip_smoke.POLAR_PIN_OUTER, chip_smoke.POLAR_PIN_CUMUL)
    for label, (outer, cumul, _) in chip_smoke.MPEC_PINS.items():
        got = res["case9_mpec"][label]
        assert (got["outer"], got["cumul"]) == (outer, cumul)
    assert [p[:2] for p in res["case9_rolling"]["periods"]] == [
        p[:2] for p in chip_smoke.ROLLING_PINS]
    assert res["case9_rolling"]["pf_residual"] <= 1e-6
    assert res["main_mpec"]["nstorage"] == 1   # ceil(9 * 0.1)
    assert set(res["polar"]) == {"f64", "f32"}
    assert res["case9_qp"]["outer"] == chip_smoke.QP_PIN_ITERS
    assert res["case9_qp"]["cumul"] == chip_smoke.QP_PIN_ITERS
    assert abs(res["case9_qp"]["obj"] - chip_smoke.QP_PIN_OBJ) <= 1e-8
    assert res["main_qp"]["mismatch"] > 0.0
    assert set(res["qpsub"]) == {"f64", "f32", "f64_nolimit", "f32_nolimit"}
    # phase 11: the fused drivers against the host loops, on every main
    # path and the case9 pins (cut), the same counts as the phases' own runs
    for label, base in (("phase 4", "main"), ("phase 5", "main_mp"),
                        ("phase 7", "main_mpec"), ("phase 8", "main_polar")):
        assert res["fused"][label]["rate"] > 0.0
        assert res["fused"][label]["launches"] == res[base]["launches"]
    assert res["fused"]["phase 10a mixed"]["cumul"] == res["main_mixed"][
        "cumul"]
    assert res["fused"]["case9 QP (3c)"]["cumul"] == 40
    assert res["fused"]["loop"]["dx_all"] == 0.0
    for label, base in (("phase 10b sorted", "main_sorted"),
                        ("phase 9a mesh", "main_mesh1")):
        assert res["fused"][label]["cumul"] == res[base]["cumul"]
        assert res["fused"][label]["obj"] == res[base]["obj"]
    assert out.count("fused == host") == 15
    names = [k["name"] for k in res["kernels"]]
    assert names == ["tron_alm_branch", "tron_alm_ramp", "tron_alm_qpsub",
                     "bus_scatter", "tron_alm_polar", "graph_loop",
                     *chip_smoke.HOOK_KERNELS, *chip_smoke.BRANCH_IO_KERNELS,
                     *chip_smoke.MP_HOOK_KERNELS]
    for k in res["kernels"]:
        assert set(k) == {"name", "route", "source", "replaces", "launches",
                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms", "device_ms",
                          "enqueue_ms"}
        assert k["bound_by"] in ("bytes", "operations")
        assert k["bound_ms"] > 0.0
        assert (k["library_ms"] is None) == (k["name"] != "bus_scatter")
        assert os.path.isfile(os.path.join(ROOT, k["source"]))
        path, line = k["replaces"].split(" ")[0].split(":")
        with open(os.path.join(ROOT, path)) as f:
            text = f.read().splitlines()[int(line) - 1]
        # a TPU kernel's function, the JAX call that runs the polar batch
        # as plain XLA, the JAX loop that the graph's loop replaces, or the
        # JAX hook or branch update code whose XLA fusions a hook, branch
        # I/O or multi-period hook kernel stands for
        assert {"tron_alm_polar": "tron_batched(",
                "graph_loop": "lax.while_loop("}.get(k["name"],
                                                    "def ") in text
    json.dumps(res["kernels"])


def test_bounds_at_synth_9241():
    """The bound helper's byte counts at the shapes of synthetic 9241 buses
    (15,710 lines, so 31,420 arcs): the single-period scatter reads 2.01 MB
    of arc values, 0.13 MB of idx and 0.04 MB of ptr and writes 0.59 MB; a
    branch TRON lane reads 54 values and a flag and writes 10 values and two
    ints, 521 B; the scatter folded over 8 periods of synthetic 2869 buses
    (4,877 lines) moves 6.5 MB."""
    from exaadmm_tpu_torch.ops import bounds
    from exaadmm_tpu_torch.utils.synthetic import synthetic_case

    data = synthetic_case(9241, seed=0, line_ratio=1.7)
    assert (data.nbus, data.nline) == (9241, 15710)
    nb = bounds.scatter_bytes(2 * data.nline, data.nbus, 8, 8)
    assert nb == {"vals": 2_010_880, "idx": 125_680, "ptr": 36_968,
                  "out": 591_424, "total": 2_764_952}
    ms, by = bounds.bound(nb["total"], bounds.scatter_ops(2 * data.nline, 8))
    assert by == "bytes" and ms == pytest.approx(2_764_952 / 3.35e9)
    nt = bounds.tron_bytes("tron_alm_branch", data.nline, 8)
    assert nt["total"] == 521 * data.nline == 8_184_910
    assert bounds.tron_bytes("tron_alm_branch", 1, 4)["total"] == 265
    assert bounds.scatter_bytes(2 * 4877, 2869, 64, 8)["total"] == 6_513_472
    # operations grow with the steps the lanes took
    few = bounds.tron_ops("tron_alm_branch", 15710, 15710, 15710)
    many = bounds.tron_ops("tron_alm_branch", 84807, 27335, 15710)
    assert 0 < few < many
    assert bounds.step_ops("tron_alm_ramp") < bounds.step_ops(
        "tron_alm_qpsub") < bounds.step_ops("tron_alm_branch")


def test_script_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_polar_bound_below_branch():
    """The polar instance moves 425 B a lane (46 values and a flag read, 6
    values and two ints written) against the branch's 521, and does fewer
    operations a step; its bound on the same batch is positive and below
    the branch's."""
    from exaadmm_tpu_torch.ops import bounds

    B = 15710
    assert bounds.tron_bytes("tron_alm_polar", 1, 8)["total"] == 425
    assert 0 < bounds.step_ops("tron_alm_polar") < bounds.step_ops(
        "tron_alm_branch")
    polar = bounds.bound(bounds.tron_bytes("tron_alm_polar", B, 8)["total"],
                         bounds.tron_ops("tron_alm_polar", 5 * B, B, B))[0]
    branch = bounds.bound(bounds.tron_bytes("tron_alm_branch", B, 8)["total"],
                          bounds.tron_ops("tron_alm_branch", 5 * B, B, B))[0]
    assert 0.0 < polar < branch
