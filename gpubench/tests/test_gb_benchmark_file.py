"""BENCHMARK.json against the benchmark's contract: its keys, names,
units and bounds, and that every configuration, traffic mix, limits file
and per-layer reader it names is a file of its own."""
import json
import re

from gpubench import bench, check

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _spec():
    return bench.benchmark()


def test_top_level_keys_and_sizes():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(spec)) < 64 * 1024
    assert 1 <= len(spec["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in spec["paths"])
    assert 1 <= len(spec["command"]) <= 32
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51


def test_names_units_and_one_line_texts():
    spec = _spec()
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            names.append(m["name"])
    texts = [c["why"] for c in spec["configs"] + spec["workloads"]]
    texts += [c["source"] for c in spec["configs"]]
    texts += [m["layer"] for m in spec["per_layer"]]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
    assert len(names) == len(set(names))


def test_bounds_and_metrics_per_cell():
    spec = _spec()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
    for w in spec["workloads"]:
        cell = bench.cell(w["name"], spec)
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in reported


def test_every_named_file_exists():
    spec = _spec()
    root = bench.ROOT
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith(spec["paths"][0] + "/") and (root / f).is_file()
    for w in spec["workloads"]:
        cell = bench.cell(w["name"], spec)
        family = cell["config"]["family"]
        for part in ("reference", "flops"):
            assert (bench.HERE / part / f"{family}.py").is_file()
        kind = cell["traffic"]["kind"]
        assert (bench.HERE / "workloads" / f"{kind}.py").is_file()
        assert cell["limits"] and set(cell["limits"]) <= set(check.NUMBERS)
    for m in spec["per_layer"]:
        assert hasattr(bench.metric_reader(m["name"]), "read")


def test_every_reader_counter_resolves():
    for m in _spec()["per_layer"]:
        for spec in getattr(bench.metric_reader(m["name"]), "COUNTERS", ()):
            assert isinstance(bench.counter(spec), (int, float)), spec
