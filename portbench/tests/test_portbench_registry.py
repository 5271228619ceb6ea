"""A cell, a configuration, a traffic mix and a per-layer metric are
found by name, so each can be added as a new file."""
import json
import shutil

import pytest

from portbench import registry
from portbench.tests import tiny

BENCH = registry.benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_committed_cell_found_by_name(name):
    cell, config, traffic = registry.cell_spec(name)
    assert cell["name"] == name and config["name"] == cell["config"]
    assert traffic["name"] == cell["traffic"]
    assert registry.runner(config["runner"]).Runner


def copy_base(tmp_path):
    for kind in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(registry.HERE / kind, tmp_path / kind)
    return tmp_path


def test_new_cell_and_config_as_files_only(tmp_path):
    base = copy_base(tmp_path)
    config = json.loads((base / "configs" / "zenlda-nytimes.json")
                        .read_text())
    config.update(tiny.SIZES, max_kd=tiny.MAX_KD)
    (base / "configs" / "zenlda-tiny.json").write_text(json.dumps(config))
    traffic = json.loads((base / "traffic" / "sweeps.json").read_text())
    traffic["warmup_sweeps"] = 2
    (base / "traffic" / "sweeps-twice.json").write_text(json.dumps(traffic))
    (base / "workloads" / "tiny-sweeps.json").write_text(json.dumps({
        "config": "zenlda-tiny", "traffic": "sweeps-twice", "chips": 1,
        "why": "a cell that only this directory has",
        "limits": {"init": 0, "first_sweep": 0.001, "last_sweep": 0.001,
                   "counts": 0}}))
    cell, config, traffic = registry.cell_spec("tiny-sweeps", base)
    assert config["num_topics"] == tiny.SIZES["num_topics"]
    assert traffic["warmup_sweeps"] == 2
    with pytest.raises(FileNotFoundError):
        registry.cell_spec("tiny-sweeps")
    # the committed runner runs it, and the check holds
    run = registry.runner(config["runner"]).Runner(config, traffic, cell,
                                                   5, "cpu")
    run.build({})
    run.warm_up({})
    run.window(0.05)
    run.release()
    assert run.sweeps >= 3
    assert all(v == 0 for v in run.check().values())


def test_new_metric_as_a_file_only(tmp_path):
    base = copy_base(tmp_path)
    (base / "metrics" / "sweeps_per_s.py").write_text(
        "def read(record):\n"
        "    return record['sweeps'] / record['window_s']\n")
    reader = registry.metric_reader("sweeps_per_s", base)
    assert reader({"sweeps": 6, "window_s": 3.0}) == 2.0
    assert registry.metric_reader("sweeps_per_s") is None


def test_per_layer_without_a_list_follows_its_end_to_end_metric():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b",
                                              "workloads": ["x"]}],
             "per_layer": [{"name": "m1", "moves": "a"},
                           {"name": "m2", "moves": "b"},
                           {"name": "m3", "moves": "a",
                            "workloads": ["x"]}]}
    assert [m["name"] for m in registry.per_layer_for(bench, "y")] == ["m1"]
    assert [m["name"] for m in registry.per_layer_for(bench, "x")] == [
        "m1", "m2", "m3"]


def test_unknown_names_raise():
    with pytest.raises(FileNotFoundError):
        registry.load("workloads", "no-such-cell")
    with pytest.raises(KeyError):
        registry.workload_entry(BENCH, "no-such-cell")
