"""The three examples of the PyTorch port, through ``main(argv)`` with
``--device cpu`` at their small sizes:

* ``quickstart_torch`` — its corpus is ``repro.data.synthetic_lda_corpus``'s
  bit for bit, the llh rises at every eval, and the final per-token llh
  lies within ``QUICKSTART_BAND`` of ``examples/quickstart.py``'s;
* ``distributed_lda_torch --devices 4`` — four gloo ranks (spawned, so in
  a subprocess of its own) print ``count conservation: True``;
* ``train_nytimes_lda_torch --quick`` — a run stopped at iteration 20 and
  resumed to 40 ends with the topics of one straight run of 40, since the
  draws are counter-based and the training checkpoint keeps the
  exclusion statistics beside the reference's tree (without them the
  resumed run samples other tokens: a control); the reference's session
  restores that checkpoint.
"""
import contextlib
import hashlib
import importlib.util
import io
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from helpers import REPO

EXAMPLES = os.path.join(REPO, "examples")
# quickstart's per-token llh after 30 iterations: the port's seeds 0-3
# (``quickstart_torch.py --seed s --device cpu``) gave -3.946, -3.946,
# -3.886, -4.030 (3.7% apart: which planted topics a chain has separated
# by then); the reference's (seed 0) -3.978. The band holds the port's
# spread with room.
QUICKSTART_BAND = 0.05


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(mod, argv=None):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv) if argv is not None else mod.main()
    return out, buf.getvalue()


def test_quickstart_matches_reference():
    from repro.data import synthetic_lda_corpus as ref_corpus

    (session, state, evals), out = _run(_load("quickstart_torch"),
                                        ["--device", "cpu"])
    want, want_phi = ref_corpus(seed=0, num_docs=200, num_words=300,
                                num_topics=10, avg_doc_len=50)
    c = session.corpus
    np.testing.assert_array_equal(c.word.numpy(), np.asarray(want.word))
    np.testing.assert_array_equal(c.doc.numpy(), np.asarray(want.doc))
    assert (c.num_words, c.num_docs) == (want.num_words, want.num_docs)
    llh0 = float(re.search(r"llh0 = (-?[\d.]+)", out).group(1))
    llh = [llh0] + [m["llh"] for m in evals]
    assert len(evals) == 3 and all(b > a for a, b in zip(llh, llh[1:]))
    state.check_invariants(c)
    assert out.count("  topic ") == 10

    _, ref_out = _run(_load("quickstart"))
    ref_last = float(re.findall(r"iter  30  llh\s+(-?[\d.]+)", ref_out)[0])
    ours = evals[-1]["llh"] / c.num_tokens
    theirs = ref_last / want.num_tokens
    assert abs(ours / theirs - 1) < QUICKSTART_BAND, (ours, theirs)


def test_distributed_example_conserves_counts():
    code = ("import importlib.util, sys; spec = importlib.util."
            "spec_from_file_location('ex', sys.argv[1]); "
            "m = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(m); "
            "m.main(['--devices', '4', '--device', 'cpu'])")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-c", code,
         os.path.join(EXAMPLES, "distributed_lda_torch.py")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    out = res.stdout
    assert "ranks=4 (gloo, cpu) mesh=2x2 tokens=24301" in out
    assert "count conservation: True" in out
    llh = [float(x) for x in re.findall(r"llh\s+(-?[\d.]+)$", out, re.M)]
    llh0 = float(re.search(r"llh0 = (-?[\d.]+)", out).group(1))
    assert len(llh) == 4 and llh[-1] > llh0
    assert out.count("count conservation") == 1  # rank 0 alone prints


def _digest(state):
    return hashlib.sha256(state.topic.cpu().numpy().tobytes()).hexdigest()


def test_nytimes_stop_and_resume_equals_straight_run(tmp_path):
    mod = _load("train_nytimes_lda_torch")
    quick = ["--quick", "--device", "cpu"]
    (_, straight), out = _run(mod, quick + ["--ckpt", str(tmp_path / "a")])
    assert int(straight.iteration) == 40 and "resumed" not in out
    stop = quick + ["--ckpt", str(tmp_path / "b")]
    (_, half), _ = _run(mod, stop + ["--iters", "20"])
    assert int(half.iteration) == 20
    shutil.copytree(tmp_path / "b", tmp_path / "c")
    (session, resumed), out = _run(mod, stop)
    assert "resumed from iteration 20" in out
    assert int(resumed.iteration) == 40
    assert _digest(resumed) == _digest(straight)
    for f in ("n_wk", "n_kd", "n_k"):
        assert bool((getattr(resumed, f) == getattr(straight, f)).all()), f
    resumed.check_invariants(session.corpus)
    # the training tree is the reference's; the statistics sit beside it
    from repro_torch.train.checkpoint import CheckpointManager

    leaves, _, step = CheckpointManager(str(tmp_path / "b")).restore_latest()
    assert step == 40 and sorted(leaves) == ["iteration", "topic"]
    # control: without the statistics a resume samples other tokens
    shutil.rmtree(tmp_path / "c" / "exclusion")
    (_, reset), _ = _run(mod, quick + ["--ckpt", str(tmp_path / "c")])
    assert _digest(reset) != _digest(straight)


def test_nytimes_default_device_is_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(_load("train_nytimes_lda_torch"),
             ["--quick", "--ckpt", str(tmp_path)])


def test_reference_restores_the_examples_checkpoint(tmp_path):
    """A port checkpoint of a run with exclusion (its statistics beside
    the tree) restores in the reference's ``TrainSession``: the same
    iteration and topics, counts rebuilt from them."""
    import jax

    from repro.core.types import LDAHyperParams as RefHyper
    from repro.data import synthetic_corpus
    from repro.train.session import RunConfig as RefRunConfig
    from repro.train.session import TrainSession as RefSession

    (_, port), _ = _run(_load("train_nytimes_lda_torch"),
                        ["--quick", "--device", "cpu", "--iters", "20",
                         "--ckpt", str(tmp_path)])
    corpus = synthetic_corpus(0, num_docs=300, num_words=500,
                              avg_doc_len=60, zipf_a=1.2)
    ref = RefSession(corpus, RefHyper(num_topics=32, alpha=0.05, beta=0.01),
                     RefRunConfig(algorithm="zen", init="sparse_word",
                                  sparse_init_degree=0.2, exclusion_start=10,
                                  num_iterations=20,
                                  train_checkpoint_dir=str(tmp_path)))
    st = ref.run(jax.random.key(0))
    assert int(st.iteration) == 20
    np.testing.assert_array_equal(np.asarray(st.topic),
                                  port.topic.numpy())
    np.testing.assert_array_equal(np.asarray(st.n_wk), port.n_wk.numpy())
