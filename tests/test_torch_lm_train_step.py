"""The port's LM train step (``repro_torch.train.train_step``) against the
reference's: for each of the ten ``-smoke`` configs in float32, one step
from the reference's parameters on the same batch, each config with its
own optimizer (loss, ce, aux and grad_norm within 1e-4; every gradient
within 1e-4 of ``jax.grad``'s, scaled by the leaf's largest |g|; the
parameters after the step within 1e-4); the port of
``test_train_step_finite_and_decreases``; microbatching (1 vs 4, and
against the reference's microbatched step); the three remat policies;
and serving a trainable model builds no graph."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_config
from repro.models import model as R
from repro.train.optimizer import OptConfig as ROpt
from repro.train.optimizer import make_optimizer as r_make
from repro.train.train_step import TrainState as RState
from repro.train.train_step import init_train_state as r_init_state
from repro.train.train_step import make_train_step as r_make_step
from repro_torch.configs import get_config
from repro_torch.models import model as P
from repro_torch.models.convert import _tree_path
from repro_torch.train.optimizer import OptConfig, make_optimizer
from repro_torch.train.train_step import (
    TrainState,
    compute_grads,
    init_train_state,
    make_train_step,
)
from torch_lm_common import ARCHS, TOL, batch, both_params, smoke_cfg
from torch_lm_common import to_jax, to_torch

LR = 1e-3
# AdamW's first step moves an element by ~lr * sign(g) whatever |g|: where
# |g| is at the noise of the two packages' sums the signs may differ, so
# the post-step parameters leave out (and count) the elements whose
# reference gradient is below this share of the leaf's largest
SIGN_FLOOR = 1e-6


def _lm_batch(cfg, b=2, s=16, seed=0):
    out = batch(cfg, b, s, seed)
    out["labels"] = np.roll(out["tokens"], -1, axis=1)
    return out


def _ref_leaf(tree, name):
    keys, index = _tree_path(name)
    for k in keys:
        tree = tree[k]
    return np.asarray(tree if index is None else tree[index], np.float32)


def _port_state(lm, cfg, lr=LR):
    init, _ = make_optimizer(cfg.optimizer, OptConfig(learning_rate=lr))
    lm.requires_grad_(True)
    return TrainState(lm, init(lm), torch.zeros((), dtype=torch.int32))


def _ref_state(tree, cfg, lr=LR):
    init, _ = r_make(cfg.optimizer, ROpt(learning_rate=lr))
    return RState(tree, init(tree), jnp.zeros((), jnp.int32))


def _params_close(lm, ref_params, ref_grads):
    """Every parameter within TOL of the reference's after the step, but
    for the sign-noise elements; returns how many were left out."""
    left_out = 0
    for name, p in lm.named_parameters():
        want = _ref_leaf(ref_params, name)
        g = np.abs(_ref_leaf(ref_grads, name))
        keep = g >= SIGN_FLOOR * (g.max() or 1.0)
        left_out += int((~keep).sum())
        np.testing.assert_allclose(p.detach().numpy()[keep], want[keep],
                                   err_msg=name, **TOL)
    return left_out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    cfg = smoke_cfg(arch)
    tree, lm = both_params(cfg)
    inp = _lm_batch(cfg)
    ref_grads = jax.grad(lambda p: R.loss_fn(p, cfg, to_jax(inp))[0])(tree)
    ref_grads = jax.tree.map(np.asarray, ref_grads)
    r_state, r_m = jax.jit(r_make_step(cfg, ROpt(learning_rate=LR)))(
        _ref_state(tree, cfg), to_jax(inp))

    state = _port_state(lm, cfg)
    loss, metrics, grads = compute_grads(lm, cfg, to_torch(inp))
    np.testing.assert_allclose(float(loss), float(r_m["loss"]), **TOL)
    for name, g in grads.items():
        want = _ref_leaf(ref_grads, name)
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(g.numpy() / scale, want / scale,
                                   err_msg=name, **TOL)
    p_state, p_m = make_train_step(cfg, OptConfig(learning_rate=LR))(
        state, to_torch(inp))
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(p_m[k]), float(r_m[k]),
                                   err_msg=k, **TOL)
    assert int(p_state.step) == int(r_state.step) == 1
    total = sum(p.numel() for p in lm.parameters())
    left_out = _params_close(lm, jax.tree.map(np.asarray, r_state.params),
                             ref_grads)
    assert left_out < 0.1 * total


def _smoke_batch(cfg, b=2, s=16):
    """``tests/test_models_smoke.py``'s constant batch, in the port."""
    out = {"tokens": torch.ones((b, s), dtype=torch.int32),
           "labels": torch.ones((b, s), dtype=torch.int32)}
    if cfg.family == "encdec":
        out["enc_embeds"] = torch.ones((b, s, cfg.d_model),
                                       dtype=P.dtype_of(cfg))
    if cfg.mrope:
        out["positions"] = torch.arange(s, dtype=torch.int32)[
            None, :, None].expand(b, s, 3)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_finite_and_decreases(arch):
    """The port of the reference's test: its smoke config (bf16), 4 steps
    on a constant batch; the loss is finite and falls."""
    cfg = get_config(arch + "-smoke")
    opt = OptConfig(learning_rate=3e-3)
    st = init_train_state(0, cfg, opt, device="cpu")
    step = make_train_step(cfg, opt)
    b = _smoke_batch(cfg)
    losses = []
    for _ in range(4):
        st, m = step(st, b)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0]  # overfits a constant batch
    assert int(st.step) == 4


def test_microbatch_equivalence():
    """The port of the reference's test: qwen2-vl's smoke config in bf16,
    1 against 4 microbatches, parameters within 2e-3."""
    cfg = get_config("qwen2-vl-2b-smoke")
    rng = np.random.default_rng(0)
    b = {"tokens": torch.from_numpy(rng.integers(0, 100, (8, 16))
                                    .astype(np.int32)),
         "labels": torch.from_numpy(rng.integers(0, 100, (8, 16))
                                    .astype(np.int32))}
    s1, m1 = make_train_step(cfg)(init_train_state(1, cfg, device="cpu"), b)
    s2, m2 = make_train_step(cfg, num_microbatches=4)(
        init_train_state(1, cfg, device="cpu"), b)
    for (n, a), (_, c) in zip(s1.params.named_parameters(),
                              s2.params.named_parameters()):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   c.detach().float().numpy(), atol=2e-3,
                                   err_msg=n)
    # the reference's microbatched metrics: "ce" holds the loss, aux 0
    assert float(m2["ce"]) == float(m2["loss"]) and float(m2["aux"]) == 0
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-2)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "grok-1-314b"])
def test_microbatched_step_matches_reference(arch):
    """4 microbatches in both packages from the reference's float32
    parameters: the float32 gradient sums, the metrics and the parameters
    after the step (AdamW; grok-1's smoke config: Adafactor and the MoE
    aux, which the microbatched metrics drop as the reference's do)."""
    cfg = smoke_cfg(arch)
    tree, lm = both_params(cfg)
    inp = _lm_batch(cfg, b=8)
    r_state, r_m = jax.jit(r_make_step(cfg, ROpt(learning_rate=LR),
                                       num_microbatches=4))(
        _ref_state(tree, cfg), to_jax(inp))
    p_state, p_m = make_train_step(cfg, OptConfig(learning_rate=LR),
                                   num_microbatches=4)(
        _port_state(lm, cfg), to_torch(inp))
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(p_m[k]), float(r_m[k]),
                                   err_msg=k, **TOL)
    assert float(p_m["aux"]) == 0 and float(p_m["ce"]) == float(p_m["loss"])
    ref_grads = jax.tree.map(np.asarray, jax.grad(
        lambda p: R.loss_fn(p, cfg, to_jax(inp))[0])(tree))
    _params_close(lm, jax.tree.map(np.asarray, r_state.params), ref_grads)


class _CountMatmuls(TorchDispatchMode):
    OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default)

    def __init__(self):
        super().__init__()
        self.matmuls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.matmuls += func in self.OPS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_equal_grads(arch):
    """``none``, ``nothing_saveable`` and ``dots`` give bit-equal loss and
    gradients; ``nothing_saveable`` recomputes the stacks' matrix
    products in the backward pass, ``dots`` saves them (as many as without
    remat)."""
    inp = to_torch(_lm_batch(smoke_cfg(arch)))
    out = {}
    for policy in ("none", "nothing_saveable", "dots"):
        cfg = smoke_cfg(arch, remat_policy=policy)
        lm = P.init_params(0, cfg, device="cpu").requires_grad_(True)
        with _CountMatmuls() as count:
            loss, _, grads = compute_grads(lm, cfg, inp)
        out[policy] = (loss, grads, count.matmuls)
    loss0, grads0, mm0 = out["none"]
    for policy in ("nothing_saveable", "dots"):
        loss, grads, _ = out[policy]
        assert torch.equal(loss, loss0), policy
        assert all(torch.equal(grads[n], grads0[n]) for n in grads0), policy
    assert out["dots"][2] == mm0 < out["nothing_saveable"][2]


def test_serving_a_trainable_model_builds_no_graph():
    """Decode and prefill run under no_grad: a trained model's in-place
    cache writes leave the caches and logits free of autograd history."""
    cfg = smoke_cfg("qwen3-8b")
    lm = P.init_params(0, cfg, device="cpu").requires_grad_(True)
    cache = P.init_cache(cfg, 2, 32, device="cpu")
    tok = torch.tensor([3, 4], dtype=torch.int32)
    for _ in range(3):
        logits, cache = P.decode_step(lm, cfg, tok, cache)
    assert not logits.requires_grad and not cache.k.requires_grad
    logits, cache = P.prefill_with_cache(
        lm, cfg, torch.ones((2, 5), dtype=torch.int32), 16)
    assert not logits.requires_grad and not cache.v.requires_grad
    assert all(p.requires_grad for p in lm.parameters())


def test_init_train_state_matches_reference_layout():
    """The reference's ``init_train_state`` and the port's hold the same
    parameter count and optimizer state size for a config of each
    optimizer."""
    for arch in ("qwen3-8b", "grok-1-314b"):
        cfg = get_config(arch + "-smoke")
        ref = r_init_state(jax.random.key(0), ref_config(arch + "-smoke"))
        st = init_train_state(0, cfg, device="cpu")
        ref_n = sum(x.size for x in jax.tree.leaves(ref.params))
        assert sum(p.numel() for p in st.params.parameters()) == ref_n
        ref_opt = sum(x.size for x in jax.tree.leaves(ref.opt_state))
        port_opt = sum(x.numel() for x in jax.tree.leaves(
            st.opt_state, is_leaf=lambda x: isinstance(x, torch.Tensor)))
        assert port_opt == ref_opt
        assert all(p.requires_grad for p in st.params.parameters())
