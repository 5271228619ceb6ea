"""The traced run: ``torch.profiler`` over the window, reduced to what the
per-layer readers and the result's ``breakdown`` need.

Only events that ran on the card count toward device time: an operator's
host-side entry also carries its kernels' time, and counting both would
count that time twice. Spans (``record_function``, the benchmark's own
and any the program adds) are left out on both sides: on the device's
timeline a span covers its kernels and the gaps between them. Busy time
is the union of the device events' intervals. An idle gap is time
between two device events; each of the longest is put down to what the
host was doing when the card ran dry: the innermost host operation open
at the gap's start, with the runtime call inside it.
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, List, Tuple

# characters of an event name kept in the breakdown
NAME_CHARS = 96
# entries of each breakdown list
TOP = 10
# the benchmark's own spans
SPAN_PREFIX = "portbench."


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def mark(name: str):
    """A span of the benchmark's own around a call into the program."""
    from torch.profiler import record_function

    return record_function(name)


def events(prof) -> List[Tuple[str, bool, float, float]]:
    """(name, ran on the card, start µs, end µs) of every event the profiler
    kept, spans left out, read from its raw results: building its operator
    tree instead takes minutes for the ~10^6 events of a ``zen_cdf``
    window."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name.startswith(SPAN_PREFIX) or (
                hasattr(ev, "is_user_annotation") and ev.is_user_annotation()):
            continue
        start = ev.start_ns() / 1e3
        out.append((name, ev.device_type() == DeviceType.CUDA, start,
                    start + ev.duration_ns() / 1e3))
    return out


def summarize(evs) -> dict:
    """Device time by name, launches, busy time, and the longest idle gaps
    with what the host was doing, in seconds, from :func:`events`."""
    dev = sorted((s, e, n) for n, on_card, s, e in evs if on_card)
    ops: Dict[str, List[float]] = {}
    for s, e, name in dev:
        entry = ops.setdefault(name, [0.0, 0])
        entry[0] += (e - s) / 1e6
        entry[1] += 1
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    host = sorted((s, e, n) for n, on_card, s, e in evs if not on_card)
    return {"busy_s": busy_us / 1e6, "launches": len(dev), "ops": ops,
            "longest_gaps": [(host_at(host, gs), (ge - gs) / 1e6)
                             for gs, ge in longest]}


def host_at(host, t: float) -> str:
    """The innermost host operation open at ``t`` among ``host`` (sorted
    (start, end, name)), as ``outer > runtime call`` where the innermost
    is a CUDA runtime call."""
    i = bisect.bisect_right(host, (t, float("inf"), "")) - 1
    open_ = []
    for j in range(i, -1, -1):
        if host[j][1] >= t:
            open_.append(host[j][2])
            if not host[j][2].startswith("cuda"):
                break
    if not open_:
        return "(host between operations)"
    return f"{open_[-1]} > {open_[0]}" if len(open_) > 1 else open_[0]


def breakdown(summary: dict) -> dict:
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"device_ops": [[n[:NAME_CHARS], v[0]] for n, v in ops],
            "idle_gaps": [[n[:NAME_CHARS], v]
                          for n, v in summary["longest_gaps"]]}


def device_time(record: dict, kernels) -> Tuple[float, int]:
    """(seconds, launches) of the device events named by ``kernels``
    (function names, matched as whole words in the demangled name)."""
    pats = [re.compile(rf"(?<![A-Za-z0-9_]){re.escape(k)}(?![A-Za-z0-9_])")
            for k in kernels]
    seconds, launches = 0.0, 0
    for name, (s, n) in record["device"]["ops"].items():
        if any(p.search(name) for p in pats):
            seconds += s
            launches += n
    return seconds, launches
