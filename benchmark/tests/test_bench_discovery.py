"""``BENCHMARK.json`` against the files it names, the traffic generator's
draws, and the imports of every module under ``benchmark/``."""

import ast
import json
import re

import numpy as np
import pytest

from benchmark import harness
from benchmark.traffic import Traffic

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves_by_name():
    for cell in BENCH["workloads"]:
        c, config, traffic = harness.resolve(BENCH, cell["name"])
        assert c is cell
        assert config["model"] and traffic["mode"]
        assert callable(harness._load("grids", config["grid"]["generator"])
                        .make)
        assert set(config["reduced"]) <= set(config)
        for traced in (False, True):
            for m in harness.metrics_of(BENCH, cell, traced):
                assert callable(harness.load_reader(m["name"]))
    with pytest.raises(KeyError):
        harness.resolve(BENCH, "no.such_cell")


def test_names_units_and_references():
    configs = {c["name"] for c in BENCH["configs"]}
    cells = {c["name"] for c in BENCH["workloads"]}
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == configs
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for c in BENCH["workloads"]:
        assert NAME.match(c["name"]) and len(c["why"]) <= 200
        assert c["chips"] == 1
    for c in BENCH["configs"]:
        assert (harness.REPO / c["file"]).is_file()
        assert len(c["source"]) <= 200


def test_traffic_is_drawn_from_the_seed():
    from benchmark import traffic
    spec = json.loads((harness.HERE / "traffic" / "cold.json").read_text())
    week = traffic.week(spec)
    assert week.shape == (168,) and week.max() == 1.0
    a = [Traffic(spec, 2**33 + 1).next() for _ in range(3)]
    b = [Traffic(spec, 2**33 + 1).next() for _ in range(3)]
    assert a == b
    # every seed asks for each hour of the week once a cycle, in its order
    tr = [Traffic(spec, s) for s in (2**33 + 2, 7)]
    cycles = [[t.next() for _ in range(168)] for t in tr]
    assert sorted(cycles[0]) == sorted(cycles[1]) == sorted(week)
    assert cycles[0] != cycles[1]
    # each round of ``strata`` requests takes one hour of each load slice
    k = spec["strata"]
    slices = np.sort(week).reshape(k, -1)
    for r in range(0, 168, k):
        got = np.sort(cycles[0][r:r + k])
        assert np.all((slices[:, 0] <= got) & (got <= slices[:, -1]))
    assert Traffic(spec, 7).warmup() == 1.0
    track = json.loads((harness.HERE / "traffic" / "track.json").read_text())
    t1, t2 = Traffic(track, 11), Traffic(track, 12)
    k = track["steps_per_hour"]
    steps = [t1.warmup()] + [t1.next() for _ in range(2 * k)]
    assert steps == [t2.warmup()] + [t2.next() for _ in range(2 * k)]
    assert steps[0] == week[0] and steps[k] == week[1]
    assert steps[k // 2] == pytest.approx((week[0] + week[1]) / 2)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(harness.HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in harness.FORBIDDEN, (f, name)


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "grids/synthetic.py", "roofline.py",
                 "stats.py", "traffic.py"):
        tops = {n.split(".")[0] for n in _imports(harness.HERE / name)}
        assert tops <= {"__future__", "numpy", "scipy", "statistics"}, (
            name, tops)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types
    for m in harness.FORBIDDEN:
        monkeypatch.delitem(sys.modules, m, raising=False)
    monkeypatch.setitem(sys.modules, "exaadmm_tpu_torch_extra",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax"]
