"""Production-mesh dry-run: trace every (arch x shape x mesh) cell.

The reference lowers and compiles each cell with XLA's SPMD partitioner
on 512 simulated devices and reads the compiled program. Here each cell
runs the port's real step, once, as rank 0 of a ``"fake"`` process group
of the mesh's size (``launch.mesh.fake_world``): the parameters, the
optimizer state, the batch and the caches are DTensors placed by
``sharding.partition``'s rules over ``meta`` tensors, so nothing is
allocated and the collectives move nothing, while DTensor's sharding
propagation decides each op's local shapes and collectives as it would on
the mesh. ``launch.roofline.StepTrace`` records rank 0's local ops:

  * per-device flops and bytes, collective bytes, and a memory summary;
  * ``trace_s`` (the seconds the trace took) in place of the reference's
    ``lower_s`` / ``compile_s``;

and each record, with the torch version that traced it, is appended to
a JSON store so an interrupted sweep resumes (a record of another torch
version is traced again). A 2 x 16 x 16 cell is traced with its data
axes merged (:func:`traced_mesh`). An LDA cell runs one rank's
``dist_step`` under ``kernels="off"`` (no kernel runs on a ``meta``
tensor; the counted work is the cell's) with a ``MeshComm`` over the
fake world.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list

The mesh's device type is ``cuda`` unless ``--device cpu`` is given (the
tests pass it).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch

RESULTS_PATH = os.environ.get("DRYRUN_TORCH_RESULTS",
                              "results/dryrun_torch.json")


def _load_results(path: str) -> Dict[str, Any]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _save_results(path: str, results: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def build_step(cfg, kind: str, dims: Optional[Dict[str, int]] = None):
    """The function each cell runs (closed over the config). An LDA cell's
    is ``make(comm)`` -> ``lda_step(state, data)``."""
    from repro_torch.models.model import decode_step, forward
    from repro_torch.train.train_step import make_train_step

    if kind == "train":
        return make_train_step(cfg)
    if kind == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                logits, _ = forward(
                    params, cfg, tokens=batch.get("tokens"),
                    embeds=batch.get("embeds"),
                    positions=batch.get("positions"),
                    enc_embeds=batch.get("enc_embeds"))
            return logits

        return prefill_step
    if kind == "decode":
        def serve_step(params, token, caches):
            return decode_step(params, cfg, token, caches)

        return serve_step
    if kind == "lda":
        from repro_torch import algorithms
        from repro_torch.core.distributed import DistConfig, dist_step
        from repro_torch.core.exclusion import ExclusionConfig
        from repro_torch.core.types import LDAHyperParams

        # fail fast on unknown / non-mesh backends, as the mesh plan does
        backend = algorithms.get(cfg.algorithm)
        if not backend.supports_shard_map:
            raise ValueError(f"LDA arch {cfg.name!r}: backend "
                             f"{cfg.algorithm!r} has no cell sweep")
        hyper = LDAHyperParams(num_topics=cfg.num_topics)
        dcfg = DistConfig(algorithm=cfg.algorithm, max_kd=cfg.max_kd,
                          delta_dtype=cfg.delta_dtype,
                          kd_dtype=cfg.kd_dtype, kernels="off")

        def make(comm):
            def lda_step(state, data):
                return dist_step(state, data, comm, hyper, dcfg,
                                 dcfg.knobs(),
                                 dims["words_per_shard"] * comm.cols,
                                 ExclusionConfig())

            return lda_step

        return make
    raise ValueError(kind)


def _place(tree, shardings):
    """``tree``'s tensors as DTensors by the matching ``shardings`` tree
    (each rank keeps its chunk; nothing is communicated)."""
    from repro_torch.sharding.partition import NamedSharding, distribute

    if isinstance(shardings, NamedSharding):
        return distribute(tree, shardings)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_place(a, b) for a, b in zip(tree, shardings)))
    raise TypeError(f"cannot place {type(tree).__name__}")


def mesh_name(shape: Sequence[int]) -> str:
    return "x".join(str(int(x)) for x in shape)


def trace_cell(cfg, shape_name, shape: Sequence[int], axes: Sequence[str],
               device: str = "cuda",
               lda_dims: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """Run one cell's step as rank 0 of a fake world of ``shape`` over
    ``axes`` and return its per-device counts. ``shape_name`` names a
    ``configs.SHAPES`` entry or is a ``ShapeConfig``; an LDA cell's padded
    dims default to ``specs.lda_dims``."""
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import LDAArchConfig
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.specs import lda_cell_specs, lm_cell_specs
    from repro_torch.train.checkpoint import shard_state

    with fake_world(shape, axes, device) as mesh:
        t0 = time.perf_counter()
        if isinstance(cfg, LDAArchConfig):
            from repro_torch.core.distributed import MeshComm

            kind, inputs, _, dims = lda_cell_specs(cfg, mesh, lda_dims)
            mp = dict(zip(axes, shape))["model"]
            comm = MeshComm(math.prod(shape) // mp, mp)
            step = build_step(cfg, kind, dims)(comm)
            args = (inputs["state"], inputs["data"])
        else:
            cell = SHAPES[shape_name] if isinstance(shape_name, str) \
                else shape_name
            kind, inputs, shardings = lm_cell_specs(cfg, cell, mesh)
            step = build_step(cfg, kind)
            args = []
            for name, value in inputs.items():
                if name in ("state", "params"):
                    args.append(shard_state(value, cfg, mesh))
                else:
                    args.append(_place(value, shardings[name]))
        with roofline.StepTrace(inputs=args) as trace:
            out = step(*args)
            trace.set_outputs(out)
        trace_s = time.perf_counter() - t0
    return {
        "ok": True,
        "trace_s": round(trace_s, 3),
        "flops_per_device": float(trace.flops),
        "bytes_per_device": float(trace.bytes),
        "collective_bytes_per_device": roofline.collective_bytes(trace),
        "memory_analysis": roofline.memory_summary(trace),
        "ops": len(trace.ops),
    }


def traced_mesh(shape: Sequence[int], axes: Sequence[str]):
    """The mesh a cell is traced on: the data axes merged into one
    ``data`` axis of their product, in front of ``model``. Every rule
    shards over the data axes together (FSDP, the batch, the caches; the
    first axis outermost, as the merged axis splits), so each device
    holds the production mesh's shards and runs its flops, and DTensor's
    redistribution planner, which searched minutes a cell on the
    2 x 16 x 16 mesh, sees a 2-D one. The collectives are the merged
    mesh's: on a 3-D ``DeviceMesh`` DTensor moves a dim split over
    (pod, data) one mesh dim at a time, in more and different
    collectives, so a multi-pod record is a prediction for the merged
    mesh, and says so (``traced``)."""
    sizes = dict(zip(axes, shape))
    data = math.prod(n for a, n in sizes.items() if a != "model")
    return (data, sizes["model"]), ("data", "model")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             device: str = "cuda") -> Dict[str, Any]:
    """Trace one cell on its production mesh; returns the record."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import production_shape

    shape, axes = production_shape(multi_pod)
    traced = traced_mesh(shape, axes)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(shape),
           "traced": mesh_name(traced[0]), "device": device,
           "torch": torch.__version__}
    rec.update(trace_cell(get_config(arch), shape_name, *traced, device))
    return rec


def _failure(arch, shape, mesh, e) -> Dict[str, Any]:
    return {"arch": arch, "shape": shape, "mesh": mesh, "ok": False,
            "torch": torch.__version__,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:]}


def _done(results: Dict[str, Any], key: str) -> bool:
    """``key``'s record is ok and was traced by this torch (the counts
    depend on its version, so another's record is traced again)."""
    rec = results.get(key)
    return bool(rec and rec.get("ok")
                and rec.get("torch") == torch.__version__)


def main(argv=None) -> None:
    from repro_torch.configs import get_config, list_archs, shapes_for
    from repro_torch.configs.base import LDAArchConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells already in the results store")
    ap.add_argument("--fit", action="store_true",
                    help="also depth-fit the per-step costs (single-pod "
                         "mesh; see rooffit.py) for the roofline table")
    ap.add_argument("--out", default=RESULTS_PATH)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the mesh's device type (cuda needs a card)")
    args = ap.parse_args(argv)

    cells = []
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    for arch in archs:
        names = shapes_for(get_config(arch))
        if args.shape:
            names = [s for s in names if s == args.shape]
        cells += [(arch, s) for s in names]

    if args.list:
        for c in cells:
            print(f"{c[0]} x {c[1]}")
        print(f"total {len(cells)} cells")
        return
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a card (--device cpu traces "
                         "the same cells on a cpu mesh)")

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = _load_results(args.out)
    for arch, shape in cells:
        for multi in meshes:
            key = f"{arch}|{shape}|{'multi' if multi else 'single'}"
            if _done(results, key) and not args.force:
                print(f"[skip] {key}")
                continue
            print(f"[cell] {key} ...", flush=True)
            try:
                rec = run_cell(arch, shape, multi, args.device)
                print(f"  ok: trace {rec['trace_s']}s, "
                      f"flops/dev {rec['flops_per_device']:.3e}, "
                      f"coll B/dev {rec['collective_bytes_per_device']:.3e}, "
                      f"peak B/dev "
                      f"{rec['memory_analysis']['peak_memory_in_bytes']:.3e}",
                      flush=True)
            except Exception as e:  # record failures: they are bugs to fix
                rec = _failure(arch, shape, "2x16x16" if multi else "16x16",
                               e)
                print(f"  FAIL: {rec['error']}", flush=True)
            results[key] = rec
            _save_results(args.out, results)
        if args.fit and not isinstance(get_config(arch), LDAArchConfig):
            from repro_torch.launch.rooffit import fit_cell

            fkey = f"{arch}|{shape}|fit"
            if _done(results, fkey) and not args.force:
                print(f"[skip] {fkey}")
                continue
            print(f"[fit ] {fkey} ...", flush=True)
            try:
                rec = fit_cell(arch, shape, device=args.device)
                rec["ok"] = True
                print(f"  fitted flops/dev {rec['flops_per_device']:.3e}, "
                      f"coll B/dev {rec['collective_bytes_per_device']:.3e}",
                      flush=True)
            except Exception as e:
                rec = _failure(arch, shape, "16x16", e)
                print(f"  FAIL: {rec['error']}", flush=True)
            results[fkey] = rec
            _save_results(args.out, results)


if __name__ == "__main__":
    main()
