"""The port's command line (``python -m exaadmm_tpu_torch``) and the
single-process side of ``parallel/distributed.py``, after tests/test_cli.py.
Every run passes ``--device cpu``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from exaadmm_tpu_torch.__main__ import build_parser, main

from .test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMAND9 = os.path.join(ROOT, "data", "case9_demand")


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_acopf_json(case9_path, tmp_path, capsys):
    ckpt = str(tmp_path / "sol.npz")
    rc = main([case9_path, "--device", "cpu", "--verbose", "0", "--json",
               "--outer-iterlim", "25", "--outer-eps", "2e-5",
               "--checkpoint", ckpt])
    summary = _last_json(capsys)
    assert rc == 0
    assert summary["status"] == "Solved"
    assert 5296.0 <= summary["objval"] <= 5304.5
    assert (summary["outer"], summary["cumul"]) == (25, 1087)
    assert set(summary) == {"solver", "case", "status", "objval", "outer",
                            "cumul", "primres", "dualres", "mismatch",
                            "time_overall_s", "checkpoint"}
    # the checkpoint loads into a flat start of the same case
    import exaadmm_tpu_torch as E
    from exaadmm_tpu_torch.models.acopf import model as M
    model = M.build_model(E.opf_loaddata(case9_path, verbose=0),
                          E.Parameters(verbose=0))
    sol, meta = E.load_solution(ckpt, M.init_solution(model, 4e2, 4e4))
    assert meta["outer"] == 25 and meta["objval"] == summary["objval"]
    assert bool(torch.isfinite(sol.u.line).all())


def test_cli_mesh_two_ranks(case9_path, tmp_path, capsys):
    """``--mesh 2 --device cpu``: two local gloo ranks, the counts and
    objective of the JAX package's one-process solve at the same settings,
    rank 0's checkpoint with the padded lines."""
    import exaadmm_tpu
    ref = exaadmm_tpu.solve_acopf(case9_path, outer_iterlim=6, outer_eps=2e-5,
                                  verbose=0).info
    ckpt = str(tmp_path / "sol.npz")
    rc = main([case9_path, "--device", "cpu", "--verbose", "0", "--json",
               "--outer-iterlim", "6", "--outer-eps", "2e-5", "--mesh", "2",
               "--checkpoint", ckpt])
    summary = _last_json(capsys)
    assert rc == 1 and summary["status"] == "IterationLimit"
    assert (summary["outer"], summary["cumul"]) == (6, 315)
    assert summary["objval"] == pytest.approx(3590.3740647455093, rel=1e-8)
    assert (summary["outer"], summary["cumul"]) == (ref.outer, ref.cumul)
    assert summary["status"] == ref.status
    assert summary["objval"] == pytest.approx(ref.objval, rel=1e-8)
    with np.load(ckpt) as f:
        assert f["leaf1__u/line"].shape == (10, 8)


def test_cli_pf(case9_path, capsys):
    rc = main([case9_path, "--solver", "pf", "--verbose", "0"])
    out = _last_json(capsys)
    assert rc == 0 and out["converged"]


@pytest.mark.parametrize("solver,extra,counts", [
    ("rolling", ["--load-prefix", DEMAND9, "--end-period", "2"], None),
    ("mpacopf", ["--load-prefix", DEMAND9, "--end-period", "2"], None),
    ("qpsub", ["--rho-pq", "4000", "--rho-va", "4000"], (3, 3)),
    ("mpec", ["--storage-ratio", "0.3"], None),
    ("acopf", ["--no-linelimit", "--projection", "--fp32"], None),
])
def test_cli_other_solvers(case9_path, capsys, solver, extra, counts):
    rc = main([case9_path, "--solver", solver, "--device", "cpu",
               "--verbose", "0", "--json", "--outer-iterlim", "3"] + extra)
    summary = _last_json(capsys)
    assert rc == 1     # three outer iterations do not solve it
    assert summary["solver"] == solver
    assert summary["status"] == "IterationLimit"
    assert summary["outer"] == 3 and summary["cumul"] >= 3
    if counts:
        assert (summary["outer"], summary["cumul"]) == counts
    assert np.isfinite(summary["objval"]) and np.isfinite(summary["primres"])


def test_cli_text_summary(case9_path, capsys):
    rc = main([case9_path, "--device", "cpu", "--verbose", "0",
               "--outer-iterlim", "1", "--inner-iterlim", "2"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "status           IterationLimit" in out
    assert "cumul            2" in out


@pytest.mark.parametrize("flag", [["--branch-backend", "pallas"],
                                  ["--bus-backend", "kr"],
                                  ["--branch-backend", "xla"]])
def test_cli_rejects_tpu_flags(case9_path, flag, capsys):
    """The JAX CLI's TPU back-end flags are unknown here, even at their JAX
    defaults: exit code 2. (``--mixed-precision`` is ported.)"""
    with pytest.raises(SystemExit) as e:
        build_parser().parse_args([case9_path] + flag)
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--fp32", "--fp64"],
    ["--solver", "rolling"],
    ["--solver", "mpacopf"],
    ["--solver", "rolling", "--load-prefix", DEMAND9, "--mesh", "2"],
    ["--mixed-precision", "--fp32"],
])
def test_cli_usage_errors(case9_path, argv, capsys):
    assert main([case9_path, "--device", "cpu"] + argv) == 2
    assert capsys.readouterr().err.strip() != ""


def test_cli_defaults_match_the_jax_cli(case9_path):
    from exaadmm_tpu.__main__ import build_parser as jax_parser
    ours = vars(build_parser().parse_args([case9_path]))
    theirs = vars(jax_parser().parse_args([case9_path]))
    dropped = {"branch_backend", "bus_backend"}
    assert set(theirs) - set(ours) == dropped
    assert set(ours) - set(theirs) == {"device"}
    for k in set(ours) & set(theirs):
        assert ours[k] == theirs[k], k
    assert ours["device"] == "cuda"


def test_cli_mixed_precision(case9_path, capsys):
    """``--mixed-precision`` on the CPU: an fp64 solve with the branch batch
    in fp32 reaches Solved on case9 (without line limits, the cheaper of
    the two batches), within 1e-3 of the fp64 pin 5286.651807890947."""
    rc = main([case9_path, "--device", "cpu", "--verbose", "0", "--json",
               "--outer-iterlim", "30", "--no-linelimit",
               "--mixed-precision"])
    summary = _last_json(capsys)
    assert rc == 0 and summary["status"] == "Solved"
    assert summary["objval"] == pytest.approx(5286.651807890947, rel=1e-3)


def test_cli_default_device_needs_a_card(case9_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cuda' asked for"):
        main([case9_path, "--verbose", "0"])


def test_module_runs_as_a_script(case9_path):
    out = subprocess.run(
        [sys.executable, "-m", "exaadmm_tpu_torch", case9_path, "--solver",
         "pf", "--verbose", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0
    assert json.loads(out.stdout.strip().splitlines()[-1])["converged"]


def test_distributed_single_process_mesh(monkeypatch):
    # single process: initialize() joins nothing and creates nothing, the
    # mesh has one rank, and the rank window spans the whole padded batch
    import torch.distributed as dist
    from exaadmm_tpu_torch.parallel import distributed

    mesh = distributed.initialize_and_make_mesh(device="cpu")
    assert not dist.is_initialized()
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert distributed.process_line_slice(mesh.size * 3) == slice(0, 3)
    assert distributed.process_line_slice(12, mesh) == slice(0, 12)
    with pytest.raises(ValueError, match="no init_method"):
        distributed.initialize(world_size=2, device="cpu")
    assert distributed.choose_backend("cpu", 4) == "gloo"
    # one rank on this host and one card: NCCL, however large the run is;
    # more local ranks than cards share what there is, over gloo
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.choose_backend("cuda") == "nccl"
    assert distributed.choose_backend("cuda", 1) == "nccl"
    assert distributed.choose_backend("cuda", 2) == "gloo"
    assert distributed.rank_device("cpu", 3) == torch.device("cpu")
    assert distributed.rank_device("cuda:1", 0) == torch.device("cuda:1")
