"""The torch dry-run (``repro_torch/launch/{specs,dryrun,roofline,hloprof,
rooffit,table}.py``): every cell's specs, the smoke cells traced on a
(2, 2) fake mesh, per-device counts held to hand counts and to
``FlopCounterMode``, the LDA cell's collective bytes, the depth fit, and
the roofline helpers (as ``tests/test_specs.py`` and
``tests/test_roofline.py`` hold the reference's)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_config, list_archs, shapes_for
from repro_torch.configs.base import LDAArchConfig
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.sharding.partition import NamedSharding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dryrun_worker.py")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun") / "out.json")
    run = subprocess.run([sys.executable, WORKER, out], env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


def _leaves(tree):
    """Tensor / sharding leaves of an input or sharding tree (an ``LM``'s
    parameters by name)."""
    if isinstance(tree, (torch.Tensor, NamedSharding)):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return _leaves(dict(tree.named_parameters()))
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def test_all_cells_build_specs():
    """All 35 (arch x shape) cells build abstract inputs with a sharding
    for every input leaf, nothing allocated."""
    from repro_torch.launch.specs import lda_cell_specs, lm_cell_specs

    mesh = AbstractMesh(("data", "model"), (2, 2))
    built = 0
    for arch in list_archs():
        cfg = get_config(arch)
        if isinstance(cfg, LDAArchConfig):
            kind, inputs, shardings, dims = lda_cell_specs(cfg, mesh)
            assert kind == "lda" and dims["e_cell"] > 0
            for k in ("state", "data"):
                assert inputs[k]._fields == shardings[k]._fields
                for v, s in zip(inputs[k], shardings[k]):
                    assert isinstance(s, NamedSharding), (arch, k)
                    if isinstance(v, torch.Tensor) and v.is_meta:
                        assert len(s.spec) <= v.dim(), (arch, k)
            built += 1
            continue
        for shape_name in shapes_for(cfg):
            kind, inputs, shardings = lm_cell_specs(cfg, SHAPES[shape_name],
                                                    mesh)
            assert set(inputs) == set(shardings)
            for k in inputs:
                ins, shs = _leaves(inputs[k]), _leaves(shardings[k])
                assert len(ins) == len(shs), (arch, shape_name, k)
                assert all(t.is_meta for t in ins), (arch, shape_name, k)
                for t, s in zip(ins, shs):
                    assert len(s.spec) <= t.dim(), (arch, shape_name, k)
            built += 1
    assert built == 35


def test_smoke_cells_trace(worker):
    """Every ``-smoke`` LM cell traces on a (2, 2) fake mesh with ok: true
    and non-zero per-device counts, but the two falcon-mamba cells the
    worker leaves to the CLI (``SLOW_CELLS``, named in ROADMAP)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_dryrun_worker import SLOW_CELLS

    smoke = worker["smoke"]
    assert len(smoke["cells"]) == 33
    failed = {k: r["error"] for k, r in smoke["records"].items()
              if not r["ok"]}
    assert not failed, failed
    traced = set(smoke["records"])
    assert traced == {f"{a}|{s}" for a, s in smoke["cells"]
                      if (a, s) not in SLOW_CELLS}
    for key, rec in smoke["records"].items():
        assert rec["bytes_per_device"] > 0, key
        assert rec["memory_analysis"]["peak_memory_in_bytes"] > 0, key
        if "decode" not in key and "long" not in key:
            assert rec["flops_per_device"] > 0, key
            assert rec["collective_bytes_per_device"] > 0, key


def test_merged_mesh_against_the_3d_mesh(worker):
    """A multi-pod cell is traced with its data axes merged: on a
    (2, 2, 2) mesh and on the (4, 2) one it is traced on, a train step
    runs the same flops and holds the same peak; the 3-D mesh moves its
    (pod, data) dims one mesh dim at a time, in more collectives that
    return at least the merged mesh's bytes (the gap is printed)."""
    m = worker["merged"]
    assert m["merged_shape"] == [[4, 2], ["data", "model"]]
    a, b = m["3d"], m["merged"]
    assert a["ok"] and b["ok"]
    assert a["flops_per_device"] == b["flops_per_device"] > 0
    assert a["memory_analysis"]["peak_memory_in_bytes"] == \
        b["memory_analysis"]["peak_memory_in_bytes"]
    assert a["collective_bytes_per_device"] >= \
        b["collective_bytes_per_device"] > 0
    assert a["ops"] > b["ops"]
    coll = a["collective_bytes_per_device"] / \
        b["collective_bytes_per_device"]
    moved = a["bytes_per_device"] / b["bytes_per_device"]
    print(f"3-D / merged: collective bytes {coll}, bytes {moved}, ops "
          f"{a['ops']} / {b['ops']}, trace {a['trace_s']} / {b['trace_s']} s")


def test_one_device_counts_equal_flop_counter(worker):
    """On a (1, 1) mesh the traced step's flops are ``FlopCounterMode``'s
    count of the plain step."""
    c = worker["counts"]
    assert c["dryrun"] == c["flop_counter"] > 0


def test_one_device_dtensor_step_is_the_plain_step(worker):
    """On a (1, 1) mesh the DTensor train step takes the plain ops: two
    bf16 steps give the plain losses and parameters bit for bit."""
    o = worker["one_device"]
    assert o["kinds"] == ["DTensor"]
    assert o["dtensor"] == o["plain"] and not o["unequal"], o


def test_per_device_counts_by_hand(worker):
    """A (64, 128) @ (128, 256) float32 matmul on (2, 2): columns over
    ``model`` run a (32, 128) @ (128, 128) product and no collective; a
    contraction over ``model`` runs (64, 64) @ (64, 256) and all-reduces
    the (64, 256) float32 partial sums."""
    m = worker["matmul"]
    assert m["column"] == {"flops": 2 * 32 * 128 * 128, "coll": 0.0,
                           "local": [32, 128]}
    assert m["row"] == {"flops": 2 * 64 * 64 * 256, "coll": 64 * 256 * 4.0,
                        "local": [64, 256]}


def test_lda_cell_collective_bytes(worker):
    """The NYTIMES cell on 16 x 16: a rank all-reduces its column's ΔN_w|k,
    its row's ΔN_k|d and ΔN_k, int32: (words_per_shard + docs_per_shard +
    1) * K * 4 bytes."""
    rec, dims = worker["lda"]["record"], worker["lda"]["dims"]
    k = get_config("zenlda-nytimes").num_topics
    assert rec["ok"] and rec["mesh"] == "16x16"
    assert rec["collective_bytes_per_device"] == \
        (dims["words_per_shard"] + dims["docs_per_shard"] + 1) * k * 4
    assert rec["bytes_per_device"] > 0


def test_depth_fit_equals_full_depth(worker):
    """Eager counts are affine in depth: the fit from 2 and 4 layers equals
    the trace at 7."""
    assert worker["fit"]["fit"] == worker["fit"]["full"]


def _trace_small():
    from repro_torch.launch.roofline import StepTrace

    x = torch.empty(8, 128, device="meta")
    w = torch.empty(128, 64, device="meta")
    with StepTrace(inputs=(x, w)) as tr:
        y = torch.relu(x @ w)
        z = y.sum()
    tr.set_outputs(z)
    return tr


def test_hloprof_buckets():
    """``bytes_by_op`` sums each op's result bytes; views move none."""
    from repro_torch.launch.hloprof import biggest_tensors, bytes_by_op

    tr = _trace_small()
    agg = bytes_by_op(tr)
    assert agg["mm"] == 8 * 64 * 4
    assert agg["relu"] == 8 * 64 * 4
    assert agg["sum"] == 4
    assert biggest_tensors(tr, 1)[0][0] == 8 * 64 * 4
    assert tr.flops == 2 * 8 * 128 * 64
    mem = __import__("repro_torch.launch.roofline",
                     fromlist=["x"]).memory_summary(tr)
    assert mem["argument_size_in_bytes"] == (8 * 128 + 128 * 64) * 4
    assert mem["output_size_in_bytes"] == 4
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"] \
        + 2 * 8 * 64 * 4


def test_roofline_terms_h100():
    from repro_torch.launch.roofline import (
        HBM_BW,
        NVLINK_BW,
        PEAK_FLOPS,
        roofline_terms,
    )

    t = roofline_terms({"flops_per_device": PEAK_FLOPS,
                        "bytes_per_device": HBM_BW * 2,
                        "collective_bytes_per_device": NVLINK_BW * 0.5})
    np.testing.assert_allclose([t["compute_s"], t["memory_s"],
                                t["collective_s"]], [1.0, 2.0, 0.5])
    assert t["bottleneck"] == "memory"


def test_table_renders_small_store():
    from repro_torch.launch.table import LINK_NOTE, build_rows, render

    store = {
        "qwen3-8b|train_4k|single": {
            "ok": True, "flops_per_device": 1e15, "bytes_per_device": 1e12,
            "collective_bytes_per_device": 1e11,
            "memory_analysis": {"peak_memory_in_bytes": 1e10}},
        "qwen3-8b|train_4k|fit": {
            "ok": True, "flops_per_device": 2e15, "bytes_per_device": 1e12,
            "collective_bytes_per_device": 1e11},
        "zenlda-nytimes|train_lda|single": {
            "ok": True, "flops_per_device": 0.0, "bytes_per_device": 1e10,
            "collective_bytes_per_device": 1e8},
    }
    rows = build_rows(store)
    assert [(r["arch"], r["shape"], r["fitted"]) for r in rows] == [
        ("qwen3-8b", "train_4k", True),
        ("zenlda-nytimes", "train_lda", False)]
    assert rows[0]["bottleneck"] == "compute"
    text = render(rows)
    assert "| qwen3-8b | train_4k |" in text and "**compute**" in text
    assert "450 GB/s" in LINK_NOTE and "InfiniBand" in LINK_NOTE


def test_dryrun_and_table_cli(tmp_path, capsys):
    """``dryrun --list`` counts the reference's 35 cells; a smoke arch's
    decode cell on the 16 x 16 mesh lands in the store as ok (in a child
    process: the fake world is global state) and the table CLI reads the
    store."""
    from repro_torch.launch import dryrun, table

    dryrun.main(["--list"])
    assert "total 35 cells" in capsys.readouterr().out
    out = str(tmp_path / "store.json")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-8b-smoke", "--shape", "decode_32k", "--mesh", "single",
         "--device", "cpu", "--out", out],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(out) as f:
        store = json.load(f)
    rec = store["qwen3-8b-smoke|decode_32k|single"]
    assert rec["ok"] and rec["mesh"] == rec["traced"] == "16x16"
    assert rec["trace_s"] > 0 and rec["torch"] == torch.__version__
    table.main(["--results", out])
    assert "H100 peaks" in capsys.readouterr().out


def test_store_keeps_one_torch_version():
    """The counts depend on the torch version: a record traced by another
    is traced again on resume, and the table refuses a store that mixes
    versions."""
    from repro_torch.launch.dryrun import _done
    from repro_torch.launch.table import build_rows, torch_version

    rec = {"ok": True, "flops_per_device": 1e15, "bytes_per_device": 1e12,
           "collective_bytes_per_device": 1e11}
    store = {"qwen3-8b|train_4k|single": dict(rec, torch=torch.__version__),
             "qwen3-8b|prefill_32k|single": dict(rec, torch="0.0"),
             "qwen3-8b|decode_32k|single": dict(rec, ok=False,
                                                torch=torch.__version__)}
    assert _done(store, "qwen3-8b|train_4k|single")
    assert not _done(store, "qwen3-8b|prefill_32k|single")
    assert not _done(store, "qwen3-8b|decode_32k|single")
    assert not _done(store, "qwen3-8b|train_4k|multi")
    with pytest.raises(ValueError, match="mixes"):
        build_rows(store)
    del store["qwen3-8b|prefill_32k|single"]
    assert torch_version(store) == torch.__version__
    assert [r["shape"] for r in build_rows(store)] == ["train_4k"]
