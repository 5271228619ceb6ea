"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, and that every name it gives has its files."""
import json
import math
import re

import pytest

from portbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = registry.benchmark()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    raw = (registry.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(text_ok(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (registry.ROOT / p).is_dir()
    # the command names no file of the repo outside its paths
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths)


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert text_ok(entry[key])


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda e: e["name"])
def test_configs(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith(BENCH["paths"][0] + "/")
    spec = json.loads((registry.ROOT / config["file"]).read_text())
    assert len(config["reduced"]) <= 16
    for key in config["reduced"]:
        assert NAME.match(key) and key in spec
    assert spec["reduced"] == config["reduced"]
    assert spec["source"] == config["source"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_workloads(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    spec, _, _ = registry.cell_spec(cell["name"])
    assert (spec["config"], spec["traffic"], spec["chips"], spec["why"]) \
        == (cell["config"], cell["traffic"], cell["chips"], cell["why"])


def test_pairs_and_four_chip_cells():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda e: e["name"])
def test_metric_fields(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        # a reader file of its own
        assert registry.metric_reader(metric["name"]) is not None
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower",
                                                               "higher")
    assert metric["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", ())) <= cells


def test_each_cell_reports_enough():
    for cell in BENCH["workloads"]:
        e2e = {m["name"] for m in registry.end_to_end_for(BENCH,
                                                          cell["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.per_layer_for(BENCH, cell["name"])


def test_setup_bound_and_roofline_names():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] == 0.25 and setup[0]["unit"] == "s"
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
            if "roofline" in m["name"]:
                assert m["name"].endswith("_roofline")


def test_run_seconds_fits_a_full_check():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    # 24 cells: 2 + 14 runs each, run_seconds + 60 s a run, 2 x 90 s of
    # compiling a cell, 1200 s spare
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_layer_names_in_perf_md():
    perf = (registry.ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_limits_of_each_cell():
    for cell in BENCH["workloads"]:
        spec, _, _ = registry.cell_spec(cell["name"])
        limits = spec["limits"]
        assert limits["init"] == 0 and limits["counts"] == 0
        assert all(0 <= v < 1 and not math.isnan(v)
                   for v in limits.values())
