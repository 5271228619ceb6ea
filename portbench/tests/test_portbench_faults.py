"""Whole runs of the harness on the CPU at a tiny size, without its look
for a card: a sound run comes out correct, and a run with the timed path
broken underneath comes out not correct, once for each fault a one-chip
training cell can have (``faults.FAULTS``)."""
import pytest

from portbench import harness
from portbench.tests import faults, tiny


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_sound_run_is_correct(cell):
    result, lines = tiny.run(cell)
    assert result["correct"] is True, lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert all(v["value"] == 0 for v in result["checks"].values())
    assert lines[-len(result["checks"]):] == harness.check_lines(
        {k: v["value"] for k, v in result["checks"].items()},
        {k: v["limit"] for k, v in result["checks"].items()})


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(cell, fault):
    result, lines = tiny.run(cell, fault=fault)
    assert result["correct"] is False, lines


def test_faults_leave_nothing_planted():
    from repro_torch.core import counts

    merge = counts.delta_counts
    tiny.run("nytimes-dense-sweeps", fault="altered_count")
    assert counts.delta_counts is merge


def test_judge():
    limits = {"a": 0, "b": 0.5}
    assert harness.judge({"a": 0, "b": 0.5}, limits)
    assert not harness.judge({"a": 1, "b": 0.0}, limits)
    assert not harness.judge({"a": 0}, limits)
    assert not harness.judge({"a": 0, "b": 0.1, "c": 0}, limits)
