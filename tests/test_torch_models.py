"""The LM zoo's modules in the port against the reference, one by one, on
the same numpy inputs in float32 (rtol/atol 1e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import ssm as RS
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL
from repro_torch.models import moe as PM
from repro_torch.models import ssm as PS
from repro_torch.models.convert import load_into
from torch_lm_common import both_params, smoke_cfg

T5 = dict(rtol=1e-5, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _eq(ref, port, **tol):
    np.testing.assert_allclose(np.asarray(ref), port.detach().numpy(),
                               **(tol or T5))


def _sub(tree, module):
    """A port module loaded from a reference sub-tree (the layer-0 slice
    of a stack)."""
    load_into(module, jax.tree.map(np.asarray, tree))
    return module


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# -- norms, RoPE, MLP --------------------------------------------------------

def test_rmsnorm_and_layernorm():
    rng = _rng(1)
    x, scale, bias = _f32(rng, 2, 5, 64), _f32(rng, 64), _f32(rng, 64)
    t = torch.from_numpy
    _eq(RL.rmsnorm(x, scale), PL.rmsnorm(t(x), t(scale)))
    _eq(RL.layernorm(x, scale, bias), PL.layernorm(t(x), t(scale), t(bias)))


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_and_mrope(theta):
    rng = _rng(2)
    x = _f32(rng, 2, 7, 3, 32)
    pos = rng.integers(0, 50, (2, 7)).astype(np.int32)
    pos3 = rng.integers(0, 50, (2, 7, 3)).astype(np.int32)
    t = torch.from_numpy
    _eq(RL.apply_rope(x, pos, theta), PL.apply_rope(t(x), t(pos), theta))
    _eq(RL.apply_mrope(x, pos3, theta), PL.apply_mrope(t(x), t(pos3), theta))
    # text tokens: t == h == w makes M-RoPE RoPE
    same = np.repeat(pos[..., None], 3, -1)
    _eq(PL.apply_rope(t(x), t(pos), theta),
        PL.apply_mrope(t(x), t(same), theta), rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-medium"])
def test_mlp_silu_glu_and_tanh_gelu(arch):
    """whisper: a plain MLP under jax.nn.gelu's tanh approximation."""
    cfg = smoke_cfg(arch)
    tree = RL.init_mlp(jax.random.key(3), cfg.d_model, cfg.d_ff, cfg,
                       jnp.float32)
    port = _sub(tree, PL.MLP(cfg.d_model, cfg.d_ff, cfg,
                             PL.ParamMaker("cpu"), torch.float32))
    x = _f32(_rng(3), 2, 6, cfg.d_model)
    _eq(RL.mlp(x, tree, cfg), PL.mlp(torch.from_numpy(x), port, cfg))
    if arch == "whisper-medium":
        exact = torch.nn.functional.gelu(torch.from_numpy(x))
        assert not torch.allclose(exact, PL._act(torch.from_numpy(x),
                                                 "gelu"), atol=1e-6)


# -- attention -----------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 4)])
def test_attend_gqa_with_mask(causal, window):
    rng = _rng(4)
    q, k, v = _f32(rng, 2, 9, 4, 16), _f32(rng, 2, 9, 2, 16), \
        _f32(rng, 2, 9, 2, 8)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    bias = RA._mask_bias(pos, pos, causal, window)
    pbias = PA._mask_bias(torch.from_numpy(pos), torch.from_numpy(pos),
                          causal, window)
    _eq(bias, pbias, rtol=0, atol=0)
    _eq(RA.attend(q, k, v, bias),
        PA.attend(*map(torch.from_numpy, (q, k, v)), pbias))


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen3-8b", "qwen2-vl-2b",
                                  "minicpm3-4b"])
def test_attention_block(arch):
    """bias (qwen1.5), qk-norm (qwen3), M-RoPE (qwen2-vl), MLA
    (minicpm3)."""
    cfg = smoke_cfg(arch, num_layers=1)
    tree, lm = both_params(cfg)
    ref_p = _layer0(tree["layers"])["attn"]
    x = _f32(_rng(5), 2, 10, cfg.d_model)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10)).copy()
    t = torch.from_numpy
    if cfg.mla is not None:
        ref = RA.mla_block(x, ref_p, cfg, pos)
        port = PA.mla_block(t(x), lm.layers[0].attn, cfg, t(pos))
    else:
        ref = RA.attn_block(x, ref_p, cfg, pos)
        port = PA.attn_block(t(x), lm.layers[0].attn, cfg, t(pos))
    _eq(ref, port)


# -- MoE -----------------------------------------------------------------------

def _ref_route(x, p, cfg):
    """The reference's own dispatch lines (moe.py:54-73) on its router."""
    m = cfg.moe
    e = m.num_experts
    b, s, d = x.shape
    t = b * s
    ts = m.group_size if t % m.group_size == 0 else t
    xg = x.reshape(t // ts, ts, d)
    cap = int(max(1, round(ts * m.top_k * m.capacity_factor / e)))
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xg, p["router"]), -1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.float32)
    flat = onehot.reshape(xg.shape[0], ts * m.top_k, e)
    pie = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    pos = jnp.sum(pie * onehot, axis=-1).astype(jnp.int32)
    return np.asarray(idx), np.asarray(pos), np.asarray(pos < cap)


@pytest.mark.parametrize("arch,zero_router", [
    ("grok-1-314b", False), ("arctic-480b", False), ("grok-1-314b", True)])
def test_moe_block_and_bit_equal_dispatch(arch, zero_router):
    """Output and aux at 1e-5; the chosen experts, slot positions and
    keep/drop decisions bit-equal. A zero router ties every expert:
    ``jax.lax.top_k`` takes the lower indices, and so must the port
    (capacity then drops tokens, both alike)."""
    cfg = smoke_cfg(arch, num_layers=1, moe=dataclasses.replace(
        get_config(arch + "-smoke").moe, capacity_factor=1.0))
    tree, lm = both_params(cfg)
    ref_p = _layer0(tree["layers"])["moe"]
    port_p = lm.layers[0].moe
    if zero_router:
        ref_p = dict(ref_p, router=jnp.zeros_like(ref_p["router"]))
        port_p.router.zero_()
    x = _f32(_rng(6), 2, 16, cfg.d_model)
    y, aux = RM.moe_block(x, ref_p, cfg)
    py, paux = PM.moe_block(torch.from_numpy(x), port_p, cfg)
    _eq(y, py)
    _eq(aux, paux)
    idx, pos, keep = _ref_route(x, ref_p, cfg)
    r = PM.route(torch.from_numpy(x).reshape(1, 32, -1), port_p.router, cfg)
    np.testing.assert_array_equal(idx, r.gate_idx.numpy())
    np.testing.assert_array_equal(pos, r.pos.numpy())
    np.testing.assert_array_equal(keep, r.keep.numpy())
    if zero_router:
        assert (idx == np.array([0, 1])).all() and not keep.all()
    else:
        assert len(np.unique(idx)) > 1


def test_top_k_ties_to_the_lower_index():
    x = torch.tensor([[0.5, 0.2, 0.5, 0.2, 0.5]])
    vals, idx = PM.top_k(x, 3)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(np.asarray(ref_idx), idx.numpy())
    assert idx.tolist() == [[0, 2, 4]]


# -- SSM -----------------------------------------------------------------------

def test_causal_conv():
    rng = _rng(7)
    x, w, b = _f32(rng, 2, 11, 6), _f32(rng, 4, 6), _f32(rng, 6)
    _eq(RS._causal_conv(x, w, b),
        PS._causal_conv(*map(torch.from_numpy, (x, w, b))))


@pytest.mark.parametrize("length", [8, 16, 21])
def test_mamba1_block(length):
    cfg = smoke_cfg("falcon-mamba-7b")
    tree = RS.init_mamba1(jax.random.key(8), cfg, jnp.float32)
    port = _sub(tree, PS.Mamba1(cfg, PL.ParamMaker("cpu"), torch.float32))
    x = _f32(_rng(8), 2, length, cfg.d_model)
    _eq(RS.mamba1_block(x, tree, cfg),
        PS.mamba1_block(torch.from_numpy(x), port, cfg))


@pytest.mark.parametrize("length", [16, 32, 21, 5])
def test_mamba2_block_pads_to_the_chunk(length):
    """chunk 16: L = 21 and 5 are padded internally."""
    cfg = smoke_cfg("zamba2-1.2b")
    assert cfg.ssm.chunk == 16
    tree = RS.init_mamba2(jax.random.key(9), cfg, jnp.float32)
    port = _sub(tree, PS.Mamba2(cfg, PL.ParamMaker("cpu"), torch.float32))
    x = _f32(_rng(9), 2, length, cfg.d_model)
    _eq(RS.mamba2_block(x, tree, cfg),
        PS.mamba2_block(torch.from_numpy(x), port, cfg))


def test_segsum_minus_inf_above_the_diagonal():
    a = _f32(_rng(10), 3, 6)
    ref = np.asarray(RS._segsum(a))
    port = PS._segsum(torch.from_numpy(a)).numpy()
    assert np.array_equal(np.isneginf(ref), np.isneginf(port))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(ref[fin], port[fin], **T5)
