"""Run one cell once and print its result line.

``run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``:
set-up (imports, CUDA, the cell's runner: corpus, session, warm-up), the
measured window, then, once the window has closed and the peak memory
has been read, the check against the plain reference. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared beside its
limit); the last lines of standard error are the same numbers.

A run exits with a code other than 0 and prints no result where there is
no card or fewer than the cell asks for, where the program is not there,
and where ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` was
loaded in this process.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import registry

# top-level module names that must not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def judge(numbers: dict, limits: dict) -> bool:
    """Every limit has its number, and no number is above its limit."""
    return set(numbers) == set(limits) and all(
        numbers[k] <= limits[k] for k in limits)


def check_lines(numbers: dict, limits: dict):
    return [f"check {k}: {numbers.get(k)} (limit {limits[k]})"
            for k in limits]


def main(argv, t0: float) -> int:
    args = parse(argv)
    bench = registry.benchmark()
    entry = registry.workload_entry(bench, args.workload)
    cell, config, traffic = registry.cell_spec(args.workload)
    if (cell["config"], cell["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise ValueError(f"{args.workload}: workloads/ and BENCHMARK.json "
                         f"name different configurations or traffic")
    parts = {}
    t = time.perf_counter()
    import torch
    parts["import_torch"] = time.perf_counter() - t

    t = time.perf_counter()
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA "
              f"card(s); this machine has {have}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    parts["cuda_init"] = time.perf_counter() - t

    run = registry.runner(config["runner"]).Runner(
        config, traffic, cell, args.seed, dev)
    result, lines = run_cell(bench, args.workload, cell, run, args.seconds,
                             args.trace, t0, parts, chips=entry["chips"])
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def run_cell(bench, name, cell, run, seconds, traced, t0, parts, chips=1):
    """Set-up, window and check of one run of ``run`` (a runner's
    ``Runner``, built for the cell on its device); returns (the result
    line's object, the check's lines for standard error)."""
    import torch

    from portbench import trace

    dev = run.device
    cuda = dev.type == "cuda"
    run.build(parts)
    run.warm_up(parts)
    setup_s = time.perf_counter() - t0
    print(json.dumps({"setup_s": setup_s, "parts": parts}), flush=True)

    prof = None
    if traced:
        prof = trace.profiler()
        with prof:
            win = run.window(seconds, mark=trace.mark)
    else:
        win = run.window(seconds)
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": chips,
              "memory_peak_bytes":
                  torch.cuda.max_memory_allocated(dev) if cuda else 0}

    metrics, extra = {}, {}
    if traced:
        summary = trace.summarize(trace.events(prof))
        prof = None
        record = {"cell": name, "config": run.config,
                  "traffic": run.traffic,
                  "shape": run.shape(), "sweeps": win["sweeps"],
                  "window_s": win["wall_s"], "device_kind": kind,
                  "device": summary}
        for m in registry.per_layer_for(bench, name):
            reader = registry.metric_reader(m["name"])
            value = reader(record) if reader else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=summary["busy_s"], window_s=win["wall_s"])
        extra["breakdown"] = trace.breakdown(summary)
    else:
        values = dict(win["end_to_end"], setup_s=setup_s)
        for m in registry.end_to_end_for(bench, name):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    run.release()
    t = time.perf_counter()
    numbers = run.check()
    limits = cell["limits"]
    lines = [f"portbench: window {win['sweeps']} sweeps in {win['wall_s']} "
             f"s; check {time.perf_counter() - t} s",
             *check_lines(numbers, limits)]
    result = {"correct": judge(numbers, limits),
              "attempted": win["sweeps"], "failed": 0, "metrics": metrics,
              "device": device, **extra,
              "checks": {k: {"value": numbers.get(k), "limit": limits[k]}
                         for k in limits}}
    return result, lines
