"""The port's LM ``ServingEngine`` against ``repro.serving.ServingEngine``
(qwen3-8b-smoke, 2 layers, float32, the same parameters), its own
bookkeeping, the example, and the serving path without JAX.

The reference's engine is run with its decode calls synchronised (a spy
that waits for the logits, as ``tests/test_serving.py``'s spy does): it
mutates its host token buffer while the previous call's asynchronous
host-to-device copy may still read it, and its unsynchronised runs on the
CPU differ from one another. Emitted tokens must be equal except where the
reference's own top-2 logit gap is below ``NEAR_TIE``; every such step is
counted and printed (``pytest -s``).
"""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import torch

from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefServingEngine
from repro_torch.models import model as P
from repro_torch.serving import ServeConfig, ServingEngine
from torch_lm_common import both_params, smoke_cfg

ROOT = pathlib.Path(__file__).resolve().parent.parent
NEAR_TIE = 1e-4


def _setup():
    cfg = smoke_cfg("qwen3-8b", num_layers=2)
    return (cfg, *both_params(cfg))


def _spied(engine, sync):
    """Record (fed tokens, float32 logits) of every decode call."""
    decode = engine._decode
    calls = []

    def spy(p, t, c):
        logits, caches = decode(p, t, c)
        if sync:
            jax.block_until_ready(logits)
        calls.append((np.asarray(t).copy(),
                      np.asarray(logits, np.float32).copy()))
        return logits, caches

    engine._decode = spy
    return calls


def _serve_both(prompts, max_batch, max_new, temperature=0.0, seed=0):
    cfg, tree, lm = _setup()
    scfg = dict(max_batch=max_batch, max_len=32, temperature=temperature)
    np.random.seed(seed)
    ref = RefServingEngine(tree, cfg, RefServeConfig(**scfg))
    port = ServingEngine(lm, cfg, ServeConfig(**scfg), device="cpu",
                         rng=np.random.RandomState(seed))
    ref_calls, port_calls = _spied(ref, True), _spied(port, False)
    for e in (ref, port):
        for p in prompts:
            e.submit(p, max_new=max_new)
    ref_done = sorted(ref.run_until_done(), key=lambda r: r.uid)
    port_done = sorted(port.run_until_done(), key=lambda r: r.uid)
    return ref_done, port_done, ref_calls, port_calls


def _near_ties(calls):
    """Steps (call, slot) whose top-2 logit gap is below NEAR_TIE."""
    out = []
    for i, (_, logits) in enumerate(calls):
        top2 = np.sort(logits, axis=-1)[:, -2:]
        out += [(i, s) for s in np.nonzero(top2[:, 1] - top2[:, 0]
                                           < NEAR_TIE)[0]]
    return out


def _compare(ref_calls, port_calls, ref_done, port_done, what):
    """Equal fed tokens and logits (rtol/atol 1e-4) call by call; the
    chains may part only after a counted near-tie of the emitting call."""
    ties = set(_near_ties(ref_calls))
    print(f"{what}: {len(ref_calls)} decode calls, reference-side top-2 "
          f"near-ties (gap < {NEAR_TIE}): {len(ties)}")
    first = next((j for j, ((rt, _), (pt, _)) in enumerate(
        zip(ref_calls, port_calls)) if not np.array_equal(rt, pt)), None)
    for (_, rl), (_, pl) in zip(ref_calls, port_calls[:first]):
        np.testing.assert_allclose(rl, pl, rtol=1e-4, atol=1e-4)
    if first is not None:
        parted = np.nonzero(ref_calls[first][0] != port_calls[first][0])[0]
        assert first > 0 and all((first - 1, s) in ties for s in parted), (
            first, parted, sorted(ties))
    elif not ties:
        assert len(ref_calls) == len(port_calls)
        assert [r.out for r in ref_done] == [r.out for r in port_done]


def test_one_request_matches_reference():
    ref_done, port_done, rc, pc = _serve_both([[5, 9, 11]], 2, 6)
    assert len(port_done) == 1 and len(port_done[0].out) == 6
    _compare(rc, pc, ref_done, port_done, "1 request")


def test_four_requests_in_four_slots_match_reference():
    prompts = [[3, 1 + i, 7][: 3 - i % 2] for i in range(4)]
    ref_done, port_done, rc, pc = _serve_both(prompts, 4, 5)
    assert [r.uid for r in port_done] == [1, 2, 3, 4]
    _compare(rc, pc, ref_done, port_done, "4 requests")


def test_temperature_draws_match_reference_under_one_seed():
    """``RandomState(s).choice`` against ``np.random.seed(s)`` and the
    global ``np.random.choice``: draw for draw."""
    prompts = [[2, 4], [6, 8, 10], [12], [14, 16]]
    ref_done, port_done, rc, pc = _serve_both(prompts, 4, 6,
                                              temperature=0.7, seed=5)
    _compare(rc, pc, ref_done, port_done, "temperature 0.7")
    assert len({tuple(r.out) for r in port_done}) > 1


def test_engine_implements_greedy_decode():
    """The port's bookkeeping, as ``tests/test_serving.py`` spies the
    reference's: the fed tokens are the prompt then the outputs, each
    output the argmax of the engine's own logits for its slot, and a
    replay from a fresh cache reproduces the logits."""
    cfg, _, lm = _setup()
    engine = ServingEngine(lm, cfg, ServeConfig(max_batch=2, max_len=32),
                           device="cpu")
    calls = _spied(engine, False)
    prompt = [5, 9, 11]
    engine.submit(prompt, max_new=4)
    done = engine.run_until_done()
    assert len(done) == 1 and len(done[0].out) == 4
    assert [int(t[0]) for t, _ in calls] == prompt + done[0].out[:-1]
    for i, tok in enumerate(done[0].out):
        assert tok == int(np.argmax(calls[len(prompt) - 1 + i][1][0]))
    cache = P.init_cache(cfg, 2, 32, device="cpu")
    with torch.no_grad():
        for fed, eng_logits in calls:
            logits, cache = P.decode_step(lm, cfg, torch.from_numpy(fed),
                                          cache)
            np.testing.assert_array_equal(logits.numpy(), eng_logits)


def test_cache_resets_only_when_every_slot_is_empty():
    """The shared cache length: a request admitted while another runs
    continues the batch's cache; once all finish, the next admission
    starts a fresh one."""
    cfg, _, lm = _setup()
    engine = ServingEngine(lm, cfg, ServeConfig(max_batch=2, max_len=32),
                           device="cpu")
    engine.submit([1, 2, 3], max_new=2)
    engine.step()
    assert int(engine.caches.length[0]) == 3
    engine.submit([4, 5], max_new=1)
    engine.step()  # admits into slot 1 over the running batch
    assert int(engine.caches.length[0]) == 5
    engine.run_until_done()
    engine.submit([6], max_new=1)
    engine.step()
    assert int(engine.caches.length[0]) == 1


def test_serve_lm_example_on_cpu(capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "serve_lm_torch", ROOT / "examples" / "serve_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    done, theta = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "LM serving: 4 requests, 32 tokens" in out and "on cpu" in out
    assert [len(r.out) for r in sorted(done, key=lambda r: r.uid)] == [8] * 4
    assert theta.shape == (8,) and abs(float(theta.sum()) - 1) < 1e-5
    assert "RT-LDA inference:" in out


def test_lm_serving_path_runs_without_jax_loaded():
    code = (
        "import sys, dataclasses\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models.model import init_params\n"
        "from repro_torch.serving import ServeConfig, ServingEngine\n"
        "cfg = dataclasses.replace(get_config('qwen3-8b-smoke'), "
        "num_layers=1)\n"
        "lm = init_params(0, cfg, device='cpu')\n"
        "e = ServingEngine(lm, cfg, ServeConfig(max_batch=2, max_len=16), "
        "device='cpu')\n"
        "e.submit([1, 2], max_new=2)\n"
        "assert len(e.run_until_done()[0].out) == 2\n"
        "loaded = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not loaded, loaded\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
