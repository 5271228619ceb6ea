"""Every family's full-sequence forward in the port against the
reference (the ten ``-smoke`` configs in float32, B = 2, S = 16,
rtol/atol 1e-4), ``prefill_with_cache`` for the dense stacks, and ports
of the reference's property tests (``tests/test_models_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as R
from repro_torch.models import model as P
from repro_torch.models.moe import moe_block
from torch_lm_common import (
    ARCHS,
    TOL,
    batch,
    both_params,
    smoke_cfg,
    to_jax,
    to_torch,
)

PREFILL_ARCHS = ["qwen1.5-4b", "qwen3-8b", "grok-1-314b", "arctic-480b",
                 "qwen2-vl-2b"]


def _fwd_kwargs(d):
    return {k: v for k, v in d.items() if k != "labels"}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    cfg = smoke_cfg(arch)
    tree, lm = both_params(cfg)
    inp = batch(cfg, 2, 16)
    ref_fwd = jax.jit(lambda p, kw: R.forward(p, cfg, **kw))
    logits, aux = ref_fwd(tree, to_jax(inp))
    with torch.no_grad():
        pl, paux = P.forward(lm, cfg, **to_torch(inp))
    assert pl.shape == (2, 16, cfg.padded_vocab_size)
    np.testing.assert_allclose(np.asarray(logits), pl.numpy(), **TOL)
    np.testing.assert_allclose(float(aux), float(paux), **TOL)
    if cfg.moe is not None:
        assert float(paux) > 0
    labels = np.roll(inp["tokens"], -1, axis=1)
    lb = dict(inp, labels=labels)
    ref_loss, ref_m = R.loss_fn(tree, cfg, to_jax(lb))
    with torch.no_grad():
        loss, m = P.loss_fn(lm, cfg, to_torch(lb))
    np.testing.assert_allclose(float(ref_loss), float(loss), **TOL)
    np.testing.assert_allclose(float(ref_m["ce"]), float(m["ce"]), **TOL)


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_with_cache_matches_reference(arch):
    cfg = smoke_cfg(arch)
    tree, lm = both_params(cfg)
    toks = batch(cfg, 2, 12)["tokens"]
    ref_logits, ref_cache = R.prefill_with_cache(tree, cfg, jnp.asarray(toks),
                                                 32)
    with torch.no_grad():
        logits, cache = P.prefill_with_cache(lm, cfg, torch.from_numpy(toks),
                                             32)
    np.testing.assert_allclose(np.asarray(ref_logits), logits.numpy(), **TOL)
    for r, p in zip(ref_cache, cache):
        np.testing.assert_allclose(np.asarray(r), p.numpy(), **TOL)
    assert cache.k.shape == (cfg.num_layers, 2, 32, cfg.num_kv_heads,
                             cfg.resolved_head_dim)


def test_prefill_decode_consistency():
    """The reference's own check, on the port: prefill-then-decode logits
    equal the full forward's (rtol/atol 2e-3, its bound)."""
    cfg = smoke_cfg("qwen3-8b")
    lm = P.init_params(0, cfg, device="cpu")
    b, s = 2, 12
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32))
    with torch.no_grad():
        logits_pre, cache = P.prefill_with_cache(lm, cfg, tokens[:, :s], 32)
        dec_logits, _ = P.decode_step(lm, cfg, tokens[:, s], cache)
        full, _ = P.forward(lm, cfg, tokens=tokens)
    np.testing.assert_allclose(dec_logits.numpy(),
                               full[:, s, :cfg.vocab_size].numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(logits_pre.numpy(), full[:, s - 1].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_sliding_window_masks_distant_tokens():
    cfg = smoke_cfg("gemma3-4b", local_global_pattern=0, sliding_window=4,
                    num_layers=2)
    lm = P.init_params(0, cfg, device="cpu")
    s = 12
    t1 = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, s)).astype(np.int32))
    t2 = t1.clone()
    t2[0, 0] = (t1[0, 0] + 1) % cfg.vocab_size
    with torch.no_grad():
        l1, _ = P.forward(lm, cfg, tokens=t1)
        l2, _ = P.forward(lm, cfg, tokens=t2)
    np.testing.assert_allclose(l1[:, -1].numpy(), l2[:, -1].numpy(),
                               atol=1e-5)
    assert (l1[:, 2] - l2[:, 2]).abs().max() > 1e-6


def test_mla_cache_is_latent_sized():
    cfg = smoke_cfg("minicpm3-4b")
    cache = P.init_cache(cfg, 2, 32, device="cpu")
    m = cfg.mla
    assert cache.v is None
    assert cache.k.shape[-1] == m.kv_lora_rank + m.qk_rope_head_dim
    full_kv = 2 * cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
    assert cache.k.shape[-1] * cache.k.shape[-2] < full_kv
    ref = R.init_cache(cfg, 2, 32)
    assert ref.k.shape == tuple(cache.k.shape)


def test_moe_routes_to_multiple_experts():
    cfg = smoke_cfg("arctic-480b", dtype="bfloat16")
    lm = P.init_params(0, cfg, device="cpu")
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(0)).to(
                        torch.bfloat16)
    with torch.no_grad():
        y, aux = moe_block(x, lm.layers[0].moe, cfg)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert float(aux) > 0


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_mamba_decode_matches_forward(arch):
    """Recurrent decode == the full-sequence scan on the same prefix
    (rtol/atol 3e-3, the reference's bound)."""
    cfg = smoke_cfg(arch, num_layers=2) if arch == "falcon-mamba-7b" \
        else smoke_cfg(arch)
    lm = P.init_params(0, cfg, device="cpu")
    s = 8
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, s)).astype(np.int32))
    cache = P.init_cache(cfg, 1, s, device="cpu")
    outs = []
    with torch.no_grad():
        full, _ = P.forward(lm, cfg, tokens=tokens)
        for i in range(s):
            logits, cache = P.decode_step(lm, cfg, tokens[:, i], cache)
            outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               full[..., :cfg.vocab_size].numpy(),
                               rtol=3e-3, atol=3e-3)
