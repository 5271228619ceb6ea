"""The fake-world half of ``tests/test_torch_dryrun.py``, run in its own
process (a fake process group is global state):

    python tests/torch_dryrun_worker.py OUT.json

writes every check's numbers to OUT.json. The smoke cells are traced in a
pool of processes, each cell in a fake world of its own."""
import dataclasses
import json
import logging
import multiprocessing as mp
import sys
import time

import torch

# the two falcon-mamba smoke cells whose exact sequential scan (one op
# chain per token and layer, on ``meta`` tensors whose elementwise ops
# run in Python) takes 99 s and 136 s to trace on a CPU: traced by the
# dry-run CLI, not here (ROADMAP queue 1)
SLOW_CELLS = {("falcon-mamba-7b-smoke", "train_4k"),
              ("falcon-mamba-7b-smoke", "prefill_32k")}


def _smoke(cell):
    logging.disable(logging.WARNING)
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import trace_cell

    arch, shape = cell
    try:
        rec = trace_cell(get_config(arch), shape, (2, 2), ("data", "model"),
                         "cpu")
    except Exception as e:  # recorded, and the test names it
        rec = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    return arch, shape, rec


def smoke_cells(pool):
    """Start the smoke cells on ``pool``; returns a function that waits
    for them."""
    from repro_torch.configs import get_config, list_archs, shapes_for

    cells = [(a + "-smoke", s) for a in list_archs(lm_only=True)
             for s in shapes_for(get_config(a + "-smoke"))]
    # the train cells (the longest: backward and remat) first
    todo = sorted((c for c in cells if c not in SLOW_CELLS),
                  key=lambda c: c[1] != "train_4k")
    pending = pool.map_async(_smoke, todo, chunksize=1)

    def wait():
        return {"cells": [list(c) for c in cells],
                "records": {f"{a}|{s}": r for a, s, r in pending.get()}}

    return wait


def merged_mesh():
    """qwen3-8b-smoke's train cell, one layer, on a (2, 2, 2) fake mesh
    and on the (4, 2) mesh ``traced_mesh`` traces it on."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import trace_cell, traced_mesh

    logging.disable(logging.WARNING)
    cfg = dataclasses.replace(get_config("qwen3-8b-smoke"), num_layers=1)
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    merged = traced_mesh(shape, axes)
    return {"merged_shape": [list(merged[0]), list(merged[1])],
            "3d": trace_cell(cfg, "train_4k", shape, axes, "cpu"),
            "merged": trace_cell(cfg, "train_4k", *merged, "cpu")}


def counts_match_flop_counter():
    """qwen3-8b-smoke's train step on a (1, 1) fake mesh against
    ``FlopCounterMode`` over the plain step (both on ``meta``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import build_step, trace_cell
    from repro_torch.launch.specs import batch_specs, state_abstract

    cfg = get_config("qwen3-8b-smoke")
    rec = trace_cell(cfg, "train_4k", (1, 1), ("data", "model"), "cpu")
    state = state_abstract(cfg)
    batch = batch_specs(cfg, SHAPES["train_4k"])
    with FlopCounterMode(display=False) as fc:
        build_step(cfg, "train")(state, batch)
    return {"dryrun": rec["flops_per_device"],
            "flop_counter": float(fc.get_total_flops())}


def matmul_by_hand():
    """One matmul per layout on a (2, 2) fake mesh; the trace's counts."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import fake_world

    out = {}
    with fake_world((2, 2), ("data", "model"), "cpu") as mesh:
        x = torch.empty(64, 128, device="meta")
        w = torch.empty(128, 256, device="meta")
        # batch over data, columns over model: local (32, 128) @ (128, 128)
        xa = distribute_tensor(x, mesh, [Shard(0), Replicate()],
                               src_data_rank=None)
        wa = distribute_tensor(w, mesh, [Replicate(), Shard(1)],
                               src_data_rank=None)
        with roofline.StepTrace(inputs=(xa, wa)) as tr:
            y = xa @ wa
        out["column"] = {"flops": tr.flops,
                         "coll": roofline.collective_bytes(tr),
                         "local": list(y.to_local().shape)}
        # contraction over model: local (64, 64) @ (64, 256), partial
        # sums all-reduced into the (64, 256) float32 result
        xb = distribute_tensor(x, mesh, [Replicate(), Shard(1)],
                               src_data_rank=None)
        wb = distribute_tensor(w, mesh, [Replicate(), Shard(0)],
                               src_data_rank=None)
        with roofline.StepTrace(inputs=(xb, wb)) as tr:
            y = (xb @ wb).redistribute(mesh, [Replicate(), Replicate()])
        out["row"] = {"flops": tr.flops,
                      "coll": roofline.collective_bytes(tr),
                      "local": list(y.to_local().shape)}
    return out


def lda_cell():
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import lda_dims

    rec = run_cell("zenlda-nytimes", "train_lda", False, "cpu")
    dims = lda_dims(get_config("zenlda-nytimes"), make_production_mesh())
    return {"record": rec, "dims": dims}


def depth_fit():
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.rooffit import fit_cell

    cfg = dataclasses.replace(get_config("qwen3-8b-smoke"), num_layers=7)
    mesh = ((2, 2), ("data", "model"))
    fit = fit_cell(cfg, "train_4k", *mesh, device="cpu")
    full = trace_cell(cfg, "train_4k", *mesh, "cpu")
    return {"fit": {k: fit[k] for k in ("flops_per_device",
                                         "bytes_per_device",
                                         "collective_bytes_per_device")},
            "full": {k: full[k] for k in ("flops_per_device",
                                          "bytes_per_device",
                                          "collective_bytes_per_device")}}


def one_device_step():
    """The narrow qwen3 (bf16) on a (1, 1) fake mesh as DTensors, two
    train steps against the plain ones on the same CPU tensors."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import fake_world
    from repro_torch.sharding.partition import batch_sharding, distribute
    from repro_torch.train.checkpoint import shard_state
    from repro_torch.train.train_step import init_train_state, \
        make_train_step

    cfg = dataclasses.replace(
        get_config("qwen3-8b-smoke"), d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=256, vocab_size=512, dtype="bfloat16")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 512, (4, 64)).astype(
        np.int32)) for k in ("tokens", "labels")}
    step = make_train_step(cfg)
    st = init_train_state(0, cfg, device="cpu")
    plain = []
    for _ in range(2):
        st, m = step(st, batch)
        plain.append(float(m["loss"]))
    want = {n: p.detach().clone() for n, p in st.params.named_parameters()}
    with fake_world((1, 1), ("data", "model"), "cpu") as mesh:
        st = shard_state(init_train_state(0, cfg, device="cpu"), cfg, mesh)
        sh = batch_sharding(batch, mesh)
        placed = {k: distribute(v, sh[k]) for k, v in batch.items()}
        losses = []
        for _ in range(2):
            st, m = step(st, placed)
            losses.append(float(m["loss"]))
        kinds = {type(p).__name__ for p in st.params.parameters()}
        unequal = [n for n, p in st.params.named_parameters()
                   if not torch.equal(p.to_local(), want[n])]
    return {"plain": plain, "dtensor": losses, "kinds": sorted(kinds),
            "unequal": unequal}


def main(path):
    logging.disable(logging.WARNING)
    t0 = time.perf_counter()
    out = {}
    with mp.get_context("spawn").Pool(4) as pool:
        merged = pool.apply_async(merged_mesh)
        wait = smoke_cells(pool)  # while this process runs the rest
        for name, fn in [("counts", counts_match_flop_counter),
                         ("matmul", matmul_by_hand), ("lda", lda_cell),
                         ("fit", depth_fit),
                         ("one_device", one_device_step)]:
            out[name] = fn()
        out["smoke"] = wait()
        out["merged"] = merged.get()
    out["seconds"] = time.perf_counter() - t0
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
