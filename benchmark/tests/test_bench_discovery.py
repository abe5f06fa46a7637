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

#: the first 30 factors of the window, drawn at the commit before horizons
#: came, for two seeds in ``cold`` and (the same for every seed) in
#: ``track``: a mix of one period a request draws what it drew then
COLD_2_33_7 = [
    0.96, 0.8835, 0.5236, 0.7007, 0.7802, 0.9216, 0.5922, 0.6231, 0.95,
    0.5859, 0.77, 0.9024, 0.893, 0.54, 0.705, 0.6525, 0.83, 0.6, 0.8928,
    0.616, 0.98, 0.931, 0.539, 0.7238, 0.6825, 0.576, 0.9306, 0.67, 0.7623,
    0.9702]
COLD_12345 = [
    0.7275, 0.9212, 0.576, 0.5487, 0.9504, 0.8928, 0.693, 0.6525, 0.6825,
    0.98, 0.576, 0.6525, 0.4928, 0.8084, 0.8928, 0.9114, 0.6789, 0.9024,
    0.74, 0.6231, 0.5546, 0.95, 0.912, 0.5664, 0.588, 0.63, 0.931, 0.96,
    0.7238, 0.86]
TRACK = [
    0.62, 0.6169, 0.6138, 0.6107, 0.6076, 0.6045, 0.6013999999999999,
    0.5982999999999999, 0.5952, 0.5921, 0.589, 0.5859, 0.583575,
    0.5812499999999999, 0.578925, 0.5766, 0.574275, 0.57195, 0.569625,
    0.5673, 0.564975, 0.5626500000000001, 0.5603250000000001, 0.558,
    0.5572250000000001, 0.55645, 0.555675, 0.5549000000000001, 0.554125,
    0.55335]


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
    assert all(len(f) == 1 for f in a)
    assert a == b
    # every seed asks for each hour of the week once a cycle, in its order
    tr = [Traffic(spec, s) for s in (2**33 + 2, 7)]
    cycles = [[t.next()[0] for _ in range(168)] for t in tr]
    assert sorted(cycles[0]) == sorted(cycles[1]) == sorted(week)
    assert cycles[0] != cycles[1]
    # each round of ``strata`` requests takes one hour of each load slice
    k = spec["strata"]
    slices = np.sort(week).reshape(k, -1)
    for r in range(0, 168, k):
        got = np.sort(cycles[0][r:r + k])
        assert np.all((slices[:, 0] <= got) & (got <= slices[:, -1]))
    assert Traffic(spec, 7).warmup() == (1.0,)
    track = json.loads((harness.HERE / "traffic" / "track.json").read_text())
    t1, t2 = Traffic(track, 11), Traffic(track, 12)
    k = track["steps_per_hour"]
    steps = [t1.warmup()[0]] + [t1.next()[0] for _ in range(2 * k)]
    assert steps == [t2.warmup()[0]] + [t2.next()[0] for _ in range(2 * k)]
    assert steps[0] == week[0] and steps[k] == week[1]
    assert steps[k // 2] == pytest.approx((week[0] + week[1]) / 2)


def _mix(name):
    return json.loads((harness.HERE / "traffic" / f"{name}.json").read_text())


def test_one_period_draws_what_it_drew_before_horizons():
    for spec, seed, want in ((_mix("cold"), 2**33 + 7, COLD_2_33_7),
                             (_mix("cold"), 12345, COLD_12345),
                             (_mix("track"), 2**33 + 7, TRACK),
                             (_mix("track"), 12345, TRACK)):
        tr = Traffic(spec, seed)
        assert tr.warmup() == ((1.0,) if spec["mode"] == "cold"
                               else (0.6231,))
        assert [tr.next() for _ in range(30)] == [(f,) for f in want]


def test_a_horizon_asks_for_consecutive_hours():
    from benchmark import traffic
    spec = _mix("horizon8")
    assert spec["periods"] == 8
    assert {k: v for k, v in spec.items() if k != "periods"} == _mix("cold")
    week = traffic.week(spec)

    def horizon(start):
        # 8 hours in a row from ``start``, wrapping at Sunday 24:00
        return tuple(week[(start + np.arange(8)) % 168])
    tr, other = Traffic(spec, 2**33 + 3), Traffic(spec, 5)
    assert tr.warmup() == horizon(int(np.argmax(week)))
    # a cycle asks for the horizon of every start hour once, in an order
    # drawn from the seed
    cycles = [[t.next() for _ in range(168)] for t in (tr, other)]
    every = sorted(horizon(i) for i in range(168))
    assert sorted(cycles[0]) == sorted(cycles[1]) == every
    assert cycles[0] != cycles[1]
    Pd, Qd = traffic.loads(dict(Pd=np.array([10.0, 20.0]),
                                Qd=np.array([1.0, 2.0])), (0.5, 1.0, 0.25))
    assert Pd.shape == Qd.shape == (2, 3)
    assert Pd[:, 2].tolist() == [2.5, 5.0] and Qd[:, 0].tolist() == [0.5, 1.0]


@pytest.mark.parametrize("periods", [0, 2])
def test_track_answers_one_period_a_request(periods):
    spec = dict(_mix("track"), periods=periods)
    with pytest.raises(ValueError, match="periods"):
        Traffic(spec, 1)


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


def test_only_the_port_module_and_request_kinds_import_the_program():
    allowed = {harness.HERE / "port.py",
               *(harness.HERE / "requests").glob("*.py")}
    tests = harness.HERE / "tests"
    importers = {f for f in harness.HERE.rglob("*.py")
                 if tests not in f.parents and any(
                     n.split(".")[0] == "exaadmm_tpu_torch"
                     for n in _imports(f))}
    assert importers == allowed


def test_request_kinds_by_model():
    from benchmark import port
    from benchmark.traffic import MODES
    files = sorted((harness.HERE / "requests").glob("*.py"))
    assert {f.stem for f in files} >= {"acopf", "mpacopf"}
    for f in files:
        mod = port.kinds(f.stem)
        assert mod.REQUESTS and set(mod.REQUESTS) <= set(MODES)
        assert all(issubclass(c, port._Request)
                   for c in mod.REQUESTS.values())
        assert callable(mod.MODEL.build_model)
        assert all(callable(f) for f in mod.FAULTS.values())
    _, config, traffic = harness.resolve(BENCH, BENCH["workloads"][0]["name"])
    for model, mode in (("no_such_model", "cold"), ("mpacopf", "track")):
        with pytest.raises(ValueError, match=f"{model}.*{mode}"):
            port.make(dict(config, model=model), dict(traffic, mode=mode),
                      {}, "cpu")


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
