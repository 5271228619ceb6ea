"""``repro_torch.kernels.autotune``, and the kernels' one block shape
each, on the CPU.

* The reference test's shapes and grids (``tests/test_kernel_suite.py``'s
  autotune test) give 6 positive timings under the reference's kernel
  names (the plain versions, timed by the wall clock).
* ``apply_best`` equals the reference's on the same timing lists: empty,
  sparse-only, K-tiled-only, both families, and ties.
* No knob reaches a kernel: every grid point is the one launch, timed
  once, and ``bt``/``bk``/``bs`` change no result; the other block shapes
  exist only as ``_build.variant`` builds of a source's shape macro.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.algorithms.base import SamplerKnobs as JKnobs
from repro.kernels import autotune as jauto
from repro_torch.algorithms import SamplerKnobs
from repro_torch.kernels import _build, autotune, ops


def _inputs():
    rng = np.random.default_rng(0)
    t, k, w, d, j = 32, 16, 12, 8, 10
    n_wk = rng.integers(0, 30, (w, k)).astype(np.int32)
    i32 = torch.int32
    return dict(
        n_wk=torch.tensor(n_wk),
        n_kd=torch.tensor(rng.integers(0, 10, (d, k)), dtype=i32),
        word=torch.tensor(rng.integers(0, w, (t,)), dtype=i32),
        doc=torch.tensor(rng.integers(0, d, (t,)), dtype=i32),
        z=torch.tensor(rng.integers(0, k, (t,)), dtype=i32),
        n_k=torch.tensor(n_wk.sum(0) + 1, dtype=torch.float32),
        alpha=torch.tensor(rng.random(k) + 0.01, dtype=torch.float32),
        term=torch.tensor(rng.random(k) + 1e-3, dtype=torch.float32),
        targets=torch.tensor(rng.random(t) * 5, dtype=torch.float32),
        vals=torch.tensor(rng.random((t, j)), dtype=torch.float32),
        topics=torch.tensor(rng.integers(0, k, (t, j)), dtype=i32),
    )


def test_reference_grid_gives_six_positive_timings():
    a = _inputs()
    kw = dict(iters=1, warmup=0)
    timings = autotune.autotune_fused(
        a["n_wk"], a["n_kd"], a["word"], a["doc"], a["z"], a["alpha"],
        a["n_k"], 7, beta=0.01, w_beta=0.16, bts=(8, 16), bks=(128,),
        interpret=True, **kw)
    timings += autotune.autotune_cdf(a["n_wk"], a["word"], a["term"],
                                     a["targets"], bts=(8, 16), bks=(128,),
                                     **kw)
    timings += autotune.autotune_sparse(a["vals"], a["topics"],
                                        a["targets"], bts=(8,),
                                        bss=(128, 256), **kw)
    assert len(timings) == 6
    assert [t.kernel for t in timings] == \
        ["fused_sample"] * 2 + ["cdf_search"] * 2 + ["sparse_row"] * 2
    assert all(t.us_per_call > 0 and t.tokens_per_sec > 0 for t in timings)
    assert [(t.bt, t.bk, t.bs) for t in timings] == [
        (8, 128, 0), (16, 128, 0), (8, 128, 0), (16, 128, 0), (8, 0, 128),
        (8, 0, 256)]
    tuned = autotune.apply_best(timings, SamplerKnobs())
    assert tuned.bt in (8, 16) and tuned.bk == 128 and tuned.bs in (128, 256)
    assert autotune.apply_best([], SamplerKnobs()) == SamplerKnobs()
    assert [f.name for f in dataclasses.fields(autotune.TileTiming)] == \
        [f.name for f in dataclasses.fields(jauto.TileTiming)]


def _lists():
    f = ("fused_sample", 128, 256, 0)
    c = ("cdf_search", 256, 512, 0)
    s = ("sparse_row", 128, 0, 256)
    s2 = ("sparse_row", 256, 0, 128)
    return {
        "empty": [],
        "sparse_only": [(*s, 5.0), (*s2, 3.0)],
        "k_tiled_only": [(*f, 9.0), (*c, 4.0), (*f[:1], 256, 512, 0, 2.0)],
        "both": [(*f, 9.0), (*s, 1.0), (*c, 4.0), (*s2, 3.0)],
        "ties": [(*f, 2.0), (*c, 2.0), (*s, 1.0), (*s2, 1.0),
                 ("fused_sample", 512, 128, 0, 2.0)],
    }


@pytest.mark.parametrize("case", sorted(_lists()))
def test_apply_best_equals_the_reference(case):
    rows = _lists()[case]
    port = autotune.apply_best(
        [autotune.TileTiming(*r, 1e6 / r[-1]) for r in rows],
        SamplerKnobs(kernels="off"))
    ref = jauto.apply_best(
        [jauto.TileTiming(*r, 1e6 / r[-1]) for r in rows],
        JKnobs(kernels="off"))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_apply_best_revalidates_the_winners():
    bad = [autotune.TileTiming("sparse_row", 256, 0, 100, 1.0, 1.0)]
    with pytest.raises(ValueError, match="bs=100"):
        autotune.apply_best(bad, SamplerKnobs())


def _ops_calls(a):
    kw = dict(beta=0.01, w_beta=0.16)
    nwk_rows = a["n_wk"][a["word"].long()]
    nkd_rows = a["n_kd"][a["doc"].long()]
    return {
        "zen_sample": lambda **k: ops.zen_sample(
            nwk_rows, nkd_rows, a["z"], a["alpha"], a["n_k"], 7, **kw, **k),
        "zen_fused_sample": lambda **k: ops.zen_fused_sample(
            a["n_wk"], a["n_kd"], a["word"], a["doc"], a["z"], a["alpha"],
            a["n_k"], 7, **kw, **k),
        "sparse_row_sample": lambda **k: ops.sparse_row_sample(
            a["vals"], a["topics"], a["targets"], **k),
        "cdf_row_search": lambda **k: ops.cdf_row_search(
            a["n_wk"], a["word"], a["term"], a["targets"], **k),
    }


@pytest.mark.parametrize("name", ["zen_sample", "zen_fused_sample",
                                  "sparse_row_sample", "cdf_row_search"])
def test_tile_knobs_change_no_result(name):
    call = _ops_calls(_inputs())[name]
    knob = "bs" if name == "sparse_row_sample" else "bk"
    want = call()
    for bt in (8, 16, 128, 512):
        assert torch.equal(call(bt=bt, **{knob: 256}), want), bt


@pytest.mark.parametrize("source,macro,default", [
    ("zen_train.cu", "ZEN_TRAIN_WARPS", 32),
    ("sparse_row.cu", "SPARSE_ROW_WARPS", 8),
    ("cdf_search.cu", "CDF_SEARCH_THREADS", 256),
])
def test_block_shape_is_one_macro_of_its_source(source, macro, default):
    """The one block shape a source builds at (chip_smoke.py's autotune
    phase rebuilds it with -D other values); a variant's library is a
    file of its own."""
    src = _build._source(source)
    text = src.read_text()
    assert f"#ifndef {macro}\n#define {macro} {default}\n#endif" in text
    assert _build.target(src) == _build.target(src, ())
    other = _build.target(src, (f"{macro}={default // 2}",))
    assert other != _build.target(src) and other.parent == _build.BUILD_DIR
    with pytest.raises(ValueError, match="not one of"):
        _build._source("missing.cu")


def test_grid_points_are_one_launch_timed_once(monkeypatch):
    a = _inputs()
    calls = []
    real = autotune._time_call

    def spy(fn, device, iters, warmup):
        calls.append(1)
        return real(fn, device, iters, warmup)

    monkeypatch.setattr(autotune, "_time_call", spy)
    timings = autotune.autotune_fused(
        a["n_wk"], a["n_kd"], a["word"], a["doc"], a["z"], a["alpha"],
        a["n_k"], 7, beta=0.01, w_beta=0.16, iters=1, warmup=0)
    assert len(timings) == 4 and len(calls) == 1
    assert len({t.us_per_call for t in timings}) == 1
    calls.clear()
    timings = autotune.autotune_sparse(a["vals"], a["topics"], a["targets"],
                                       bts=(8, 16, 128, 200),
                                       bss=(128, 256), iters=1, warmup=0)
    assert len(timings) == 8 and len(calls) == 1
    # all ties: the reference's rule keeps the first point
    assert autotune.apply_best(timings, SamplerKnobs()).bt == 8
