"""The reduction of a profiled window, on events of known times, and the
raw read of a real profile."""
import pytest
import torch

from portbench import trace

EVENTS = [
    # (name, ran on the card, start µs, end µs)
    ("aten::mm", False, 0, 100),
    ("cudaLaunchKernel", False, 50, 60),
    ("aten::nonzero", False, 300, 500),
    ("cudaStreamSynchronize", False, 310, 490),
    ("kernel_a", True, 100, 200),
    ("kernel_b", True, 150, 300),   # overlaps kernel_a
    ("kernel_a", True, 350, 400),
    ("Memcpy DtoH", True, 600, 610),
]


def test_summarize():
    s = trace.summarize(EVENTS)
    assert s["launches"] == 4
    assert s["busy_s"] == pytest.approx((200 + 50 + 10) / 1e6)
    assert s["ops"]["kernel_a"] == [pytest.approx(150 / 1e6), 2]
    # the longest gap first: 400-600 in aten::nonzero's sync, then 300-350
    # as aten::nonzero starts
    assert s["longest_gaps"] == [
        ("aten::nonzero > cudaStreamSynchronize", pytest.approx(200 / 1e6)),
        ("aten::nonzero", pytest.approx(50 / 1e6))]


def test_host_at():
    host = sorted([(0, 100, "aten::mm"), (50, 60, "cudaLaunchKernel")])
    assert trace.host_at(host, 55) == "aten::mm > cudaLaunchKernel"
    assert trace.host_at(host, 70) == "aten::mm"
    assert trace.host_at(host, 150) == "(host between operations)"


def test_breakdown_is_short():
    ops = {f"k{i}": [float(i), 1] for i in range(30)}
    b = trace.breakdown({"ops": ops, "longest_gaps": [("x", 1.0)]})
    assert len(b["device_ops"]) == trace.TOP
    assert b["device_ops"][0] == ["k29", 29.0]
    assert b["idle_gaps"] == [["x", 1.0]]


def test_events_of_a_profile_leave_spans_out():
    x = torch.ones(8)
    prof = trace.profiler()
    with prof:
        for _ in range(3):
            with trace.mark("portbench.sweep"):
                x = x + 1
    evs = trace.events(prof)
    names = [e[0] for e in evs]
    assert names.count("aten::add") == 3
    assert not any(n.startswith("portbench.") for n in names)
    assert all(e[2] <= e[3] and not e[1] for e in evs)
