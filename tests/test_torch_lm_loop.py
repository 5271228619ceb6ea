"""The port's fault-tolerant loop (``repro_torch.train.loop``): the port of
``test_loop_retries_and_resumes``, a stop requested by signal mid-run
(checkpoint, then exit, then resume), LM checkpoints crossing between the
reference's ``TrainLoop`` and the port's both ways (parameters bit-equal,
``qwen3-8b-smoke`` in float32), and ``examples/train_lm_torch.py`` on the
CPU."""
import dataclasses
import importlib.util
import pathlib
import signal

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.train.loop import LoopConfig as RLoopConfig
from repro.train.loop import TrainLoop as RTrainLoop
from repro.train.optimizer import OptConfig as ROpt
from repro.train.train_step import init_train_state as r_init_state
from repro.train.train_step import make_train_step as r_make_step
from repro_torch.configs import get_config
from repro_torch.models.convert import _tree_path, params_to_reference
from repro_torch.train.checkpoint import committed_steps
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state, make_train_step
from torch_lm_common import smoke_cfg

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_loop_retries_and_resumes(tmp_path):
    calls = {"n": 0, "fails": 0}

    def flaky_step(state):
        calls["n"] += 1
        if calls["n"] == 3 and calls["fails"] == 0:
            calls["fails"] += 1
            raise RuntimeError("transient device error")
        return state + 1, {"loss": float(state)}

    td = str(tmp_path)
    loop = TrainLoop(
        flaky_step,
        LoopConfig(num_steps=10, checkpoint_every=4, checkpoint_dir=td,
                   log_every=0, max_retries=2),
        checkpoint_tree_fn=lambda s: {"state": torch.tensor(s)},
        restore_fn=lambda s, tree: int(tree["state"]),
    )
    final = loop.run(0)
    assert final == 10
    assert calls["fails"] == 1  # retried through the failure
    # a fresh loop resumes from the checkpoint, not from zero
    loop2 = TrainLoop(
        lambda s: (s + 1, {}),
        LoopConfig(num_steps=12, checkpoint_every=100, checkpoint_dir=td,
                   log_every=0),
        checkpoint_tree_fn=lambda s: {"state": torch.tensor(s)},
        restore_fn=lambda s, tree: int(tree["state"]),
    )
    final2 = loop2.run(0)
    assert final2 == 12  # resumed at 8 (last ckpt) and ran 4 more


def test_retries_exhausted_restore_the_last_checkpoint(tmp_path):
    """After ``max_retries`` failures of one step the loop goes back to the
    newest checkpoint and runs on from its step."""
    seen = []

    def step(state):
        seen.append(state)
        if state == 6 and seen.count(6) <= 2:
            raise RuntimeError("node lost")
        return state + 1, {}

    loop = TrainLoop(
        step, LoopConfig(num_steps=9, checkpoint_every=5,
                         checkpoint_dir=str(tmp_path), log_every=0,
                         max_retries=1),
        checkpoint_tree_fn=lambda s: {"state": np.int64(s)},
        restore_fn=lambda s, tree: int(tree["state"]))
    loop.run(0)
    # 0..5, step 6 fails twice, back to the checkpoint of step 5, 5..8
    assert seen == [0, 1, 2, 3, 4, 5, 6, 6, 5, 6, 7, 8]


def test_stop_requested_mid_run_checkpoints_then_exits(tmp_path):
    """SIGTERM during step 5: the step finishes, the loop saves a
    checkpoint at 5 and returns; a new loop resumes there."""
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    ran = []

    def step(state):
        ran.append(state)
        if state == 4:
            signal.raise_signal(signal.SIGTERM)
        return state + 1, {}

    cfg = LoopConfig(num_steps=10, checkpoint_every=100,
                     checkpoint_dir=str(tmp_path), log_every=0)
    try:
        loop = TrainLoop(step, cfg,
                         checkpoint_tree_fn=lambda s: {"s": np.int64(s)},
                         restore_fn=lambda s, tree: int(tree["s"]))
        assert loop.run(0) == 5
        assert ran == [0, 1, 2, 3, 4]
        assert [s for s, _ in committed_steps(str(tmp_path))] == [5]
        ran.clear()
        loop2 = TrainLoop(lambda s: (s + 1, {}), cfg,
                          checkpoint_tree_fn=lambda s: {"s": np.int64(s)},
                          restore_fn=lambda s, tree: int(tree["s"]))
        assert loop2.run(0) == 10
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return tokens, np.roll(tokens, -1, 1)


def _port_cfg():
    return dataclasses.replace(get_config("qwen3-8b-smoke"), dtype="float32")


def _flat_ref(params):
    return {name: np.asarray(leaf) for name, leaf in _named_ref(params)}


def _named_ref(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named_ref(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


def _port_flat(lm):
    return _flat_ref(params_to_reference(lm))


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """The reference's ``TrainLoop`` (the reference example's tree and
    restore) trains 3 steps and checkpoints; the port's loop, the port
    example's restore, resumes from it with parameters bit-equal."""
    cfg = smoke_cfg("qwen3-8b")
    tokens, labels = _batch(cfg)
    b = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    step = jax.jit(r_make_step(cfg, ROpt(learning_rate=1e-3)))
    loop = RTrainLoop(
        lambda s: step(s, b),
        RLoopConfig(num_steps=3, checkpoint_every=3,
                    checkpoint_dir=str(tmp_path), log_every=0),
        checkpoint_tree_fn=lambda s: {"params": s.params, "step": s.step},
        restore_fn=lambda s, tree: s._replace(params=tree["params"],
                                              step=tree["step"]))
    ref = loop.run(r_init_state(jax.random.key(0), cfg))
    ex = _example()
    port = init_train_state(1, _port_cfg(), device="cpu")
    ploop = TrainLoop(
        lambda s: (_ for _ in ()).throw(AssertionError("no step to run")),
        LoopConfig(num_steps=3, checkpoint_dir=str(tmp_path), log_every=0),
        checkpoint_tree_fn=lambda s: {"params": params_to_reference(s.params),
                                      "step": s.step},
        restore_fn=ex.restore)
    got = ploop.run(port)
    assert int(got.step) == 3
    want = _flat_ref(jax.tree.map(np.asarray, ref.params))
    have = _port_flat(got.params)
    assert sorted(want) == sorted(have)
    for name in want:
        np.testing.assert_array_equal(have[name], want[name], err_msg=name)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """The reverse: the port's loop trains 3 steps and checkpoints; the
    reference's loop resumes from it with parameters bit-equal."""
    pcfg = _port_cfg()
    tokens, labels = _batch(pcfg)
    b = {"tokens": torch.from_numpy(tokens),
         "labels": torch.from_numpy(labels)}
    step = make_train_step(pcfg, OptConfig(learning_rate=1e-3))
    ex = _example()
    loop = TrainLoop(
        lambda s: step(s, b),
        LoopConfig(num_steps=3, checkpoint_every=3,
                   checkpoint_dir=str(tmp_path), log_every=0),
        checkpoint_tree_fn=lambda s: {"params": params_to_reference(s.params),
                                      "step": s.step},
        restore_fn=ex.restore)
    port = loop.run(init_train_state(1, pcfg, device="cpu"))
    cfg = smoke_cfg("qwen3-8b")
    rloop = RTrainLoop(
        lambda s: (_ for _ in ()).throw(AssertionError("no step to run")),
        RLoopConfig(num_steps=3, checkpoint_dir=str(tmp_path), log_every=0),
        checkpoint_tree_fn=lambda s: {"params": s.params, "step": s.step},
        restore_fn=lambda s, tree: s._replace(params=tree["params"],
                                              step=tree["step"]))
    ref = rloop.run(r_init_state(jax.random.key(0), cfg))
    assert int(ref.step) == 3
    want = _port_flat(port.params)
    have = _flat_ref(jax.tree.map(np.asarray, ref.params))
    for name in want:
        np.testing.assert_array_equal(have[name], want[name], err_msg=name)
        keys, _ = _tree_path(name)
        assert keys  # every leaf named by its tree path


def test_example_trains_and_resumes_on_cpu(tmp_path, capsys):
    """``examples/train_lm_torch.py --device cpu``: a few steps, the loss
    finite; with ``--ckpt`` a second run resumes from the step-25
    checkpoint (parameters and step, as the reference's example)."""
    ex = _example()
    final, losses = ex.main(["--device", "cpu", "--steps", "4"])
    assert "finished at step 4" in capsys.readouterr().out
    assert int(final.step) == 4 and len(losses) == 4
    assert np.isfinite(losses).all()
    ck = str(tmp_path / "ck")
    first, _ = ex.main(["--device", "cpu", "--steps", "25", "--batch", "2",
                        "--seq", "16", "--ckpt", ck])
    again, more = ex.main(["--device", "cpu", "--steps", "27", "--batch",
                           "2", "--seq", "16", "--ckpt", ck])
    out = capsys.readouterr().out
    assert "finished at step 25" in out and "finished at step 27" in out
    assert len(more) == 2 and int(again.step) == 27
