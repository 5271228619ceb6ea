"""Layer stacks of every family (``repro/models/transformer.py``).

The reference scans layer-stacked parameters; here each stack is an
``nn.ModuleList`` looped in the reference's order, and a stacked cache
(leading layer axis, the reference's layout) is read and written per
layer through views. Heterogeneous patterns:

  gemma3   groups of (N local sliding-window layers, 1 global layer), then
           the trailing locals, each with its own window and theta
  zamba2   groups of ``every`` mamba2 layers, then ONE shared attention
           and MLP block (its parameters reused by every group; a KV cache
           per group)
  whisper  encoder stack, then a decoder with self- and cross-attention

Remat: while grad is enabled, each stack's layer body (and gemma3's
global layer, zamba2's shared block) runs under
``torch.utils.checkpoint`` per ``cfg.remat_policy``, where the reference
wraps the same bodies in ``jax.checkpoint``; decode and serving run
without it.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (
    MLA,
    Attention,
    KVCache,
    attn_block,
    attn_decode,
    cross_kv,
    mla_block,
    mla_decode,
)
from repro_torch.models.layers import MLP, Norm, ParamMaker, mlp, norm
from repro_torch.models.moe import MoE, moe_block
from repro_torch.models.ssm import (
    Mamba1,
    Mamba2,
    SSMCache,
    mamba1_block,
    mamba1_decode,
    mamba2_block,
    mamba2_decode,
)


# the matrix products ``jax.checkpoint_policies.checkpoint_dots`` saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _remat(fn, cfg: ArchConfig):
    """``fn`` recomputed in the backward pass per ``cfg.remat_policy``:
    ``none`` saves everything, ``dots`` saves the matrix products' outputs
    and recomputes the rest, anything else (``nothing_saveable``) saves
    only the inputs. Without grad ``fn`` runs as it is."""
    if cfg.remat_policy == "none":
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(_DOTS))

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _kv_at(caches: KVCache, i: int) -> KVCache:
    """Layer i's cache: views into the stacked tensors."""
    return KVCache(k=caches.k[i], v=None if caches.v is None else caches.v[i],
                   length=caches.length[i])


def _ssm_at(caches: SSMCache, i: int) -> SSMCache:
    return SSMCache(conv=caches.conv[i], state=caches.state[i])


def _advanced(caches: KVCache) -> KVCache:
    """The stacked cache after one decode step of every layer (each
    layer's step wrote its slot in place and advanced its length)."""
    return caches._replace(length=caches.length + 1)


# ---------------------------------------------------------------------------
# decoder layers (dense / moe / vlm families)
# ---------------------------------------------------------------------------

class DecoderLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, mk: ParamMaker, dtype: torch.dtype):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg, mk)
        self.ln2 = Norm(cfg.d_model, cfg, mk)
        self.attn = MLA(cfg, mk, dtype) if cfg.mla is not None \
            else Attention(cfg, mk, dtype)
        if cfg.moe is not None:
            self.moe = MoE(cfg, mk, dtype)
            if cfg.moe.dense_residual:
                self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg, mk, dtype)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg, mk, dtype)


def _ffn(h2: torch.Tensor, lp: DecoderLayer,
         cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    aux = _zero(h2)
    if cfg.moe is not None:
        y, aux = moe_block(h2, lp.moe, cfg)
        if cfg.moe.dense_residual:
            y = y + mlp(h2, lp.mlp, cfg)
    else:
        y = mlp(h2, lp.mlp, cfg)
    return y, aux


def decoder_layer(x: torch.Tensor, lp: DecoderLayer, cfg: ArchConfig,
                  positions: torch.Tensor, *, window: int = 0,
                  theta: Optional[float] = None, causal: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = norm(x, lp.ln1, cfg)
    if cfg.mla is not None:
        a = mla_block(h, lp.attn, cfg, positions, causal=causal)
    else:
        a = attn_block(h, lp.attn, cfg, positions, causal=causal,
                       window=window, theta=theta)
    x = x + a
    y, aux = _ffn(norm(x, lp.ln2, cfg), lp, cfg)
    return x + y, aux


def decoder_layer_decode(x: torch.Tensor, lp: DecoderLayer, cfg: ArchConfig,
                         cache: KVCache, *, window: int = 0,
                         theta: Optional[float] = None
                         ) -> Tuple[torch.Tensor, KVCache, torch.Tensor]:
    h = norm(x, lp.ln1, cfg)
    if cfg.mla is not None:
        a, cache = mla_decode(h, lp.attn, cfg, cache)
    else:
        a, cache = attn_decode(h, lp.attn, cfg, cache, window=window,
                               theta=theta)
    x = x + a
    y, aux = _ffn(norm(x, lp.ln2, cfg), lp, cfg)
    return x + y, cache, aux


def _run_layers(body, x: torch.Tensor, layers,
                cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_scan_layers``: an (x, aux) carry through the
    layers, aux starting at 0, the body under ``_remat``."""
    body = _remat(body, cfg)
    aux = _zero(x)
    for lp in layers:
        x, a = body(x, lp)
        aux = aux + a
    return x, aux


def _run_layers_cache(body, x: torch.Tensor, layers, caches, at,
                      offset: int = 0) -> torch.Tensor:
    """Decode through ``layers`` with layer i's cache ``at(caches, offset +
    i)`` (written in place)."""
    for i, lp in enumerate(layers):
        x, _, _ = body(x, lp, at(caches, offset + i))
    return x


def dense_forward(params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor):
    def body(x, lp):
        return decoder_layer(x, lp, cfg, positions, window=cfg.sliding_window)

    return _run_layers(body, x, params.layers, cfg)


def dense_decode(params, cfg: ArchConfig, x: torch.Tensor,
                 caches: KVCache) -> Tuple[torch.Tensor, KVCache]:
    def body(x, lp, c):
        return decoder_layer_decode(x, lp, cfg, c, window=cfg.sliding_window)

    x = _run_layers_cache(body, x, params.layers, caches, _kv_at)
    return x, _advanced(caches)


# ---------------------------------------------------------------------------
# gemma3-style local:global pattern
# ---------------------------------------------------------------------------

def pattern_counts(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(n_groups, n_global, n_trailing_local) for the repeating pattern."""
    group = cfg.local_global_pattern + 1
    n_groups = cfg.num_layers // group
    return n_groups, n_groups, cfg.num_layers - n_groups * group


def patterned_forward(params, cfg: ArchConfig, x: torch.Tensor,
                      positions: torch.Tensor):
    n = cfg.local_global_pattern
    n_groups, _, rem = pattern_counts(cfg)
    theta_g = cfg.rope_theta_global or cfg.rope_theta
    local, glob = params.local, getattr(params, "global")

    def local_body(x, lp):
        return decoder_layer(x, lp, cfg, positions,
                             window=cfg.sliding_window, theta=cfg.rope_theta)

    def global_body(x, lp):
        return decoder_layer(x, lp, cfg, positions, window=0, theta=theta_g)

    global_body = _remat(global_body, cfg)
    aux = _zero(x)
    for g in range(n_groups):
        x, a1 = _run_layers(local_body, x, local[g * n:(g + 1) * n], cfg)
        x, a2 = global_body(x, glob[g])
        aux = aux + a1 + a2
    if rem:
        x, a3 = _run_layers(local_body, x, local[n_groups * n:], cfg)
        aux = aux + a3
    return x, aux


def patterned_decode(params, cfg: ArchConfig, x: torch.Tensor,
                     caches: dict) -> Tuple[torch.Tensor, dict]:
    n = cfg.local_global_pattern
    n_groups, _, rem = pattern_counts(cfg)
    theta_g = cfg.rope_theta_global or cfg.rope_theta
    local, glob = params.local, getattr(params, "global")

    def local_body(x, lp, c):
        return decoder_layer_decode(x, lp, cfg, c, window=cfg.sliding_window,
                                    theta=cfg.rope_theta)

    for g in range(n_groups):
        x = _run_layers_cache(local_body, x, local[g * n:(g + 1) * n],
                              caches["local"], _kv_at, g * n)
        x, _, _ = decoder_layer_decode(x, glob[g], cfg,
                                       _kv_at(caches["global"], g), window=0,
                                       theta=theta_g)
    if rem:
        x = _run_layers_cache(local_body, x, local[n_groups * n:],
                              caches["local"], _kv_at, n_groups * n)
    return x, {"local": _advanced(caches["local"]),
               "global": _advanced(caches["global"])}


# ---------------------------------------------------------------------------
# single-block layers: falcon-mamba (mamba1), zamba2 (mamba2)
# ---------------------------------------------------------------------------

class SSMLayer(nn.Module):
    """``ln`` then a Mamba1 (``version`` 1) or Mamba2 block ``m``."""

    def __init__(self, cfg: ArchConfig, mk: ParamMaker, dtype: torch.dtype,
                 version: int):
        super().__init__()
        self.ln = Norm(cfg.d_model, cfg, mk)
        self.m = (Mamba1 if version == 1 else Mamba2)(cfg, mk, dtype)


def ssm_forward(params, cfg: ArchConfig, x: torch.Tensor):
    def body(x, lp):
        return x + mamba1_block(norm(x, lp.ln, cfg), lp.m, cfg), _zero(x)

    return _run_layers(body, x, params.layers, cfg)


def ssm_decode(params, cfg: ArchConfig, x: torch.Tensor,
               caches: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    def body(x, lp, c):
        y, c2 = mamba1_decode(norm(x, lp.ln, cfg), lp.m, cfg, c)
        return x + y, c2, None

    return _run_layers_cache(body, x, params.layers, caches, _ssm_at), caches


# ---------------------------------------------------------------------------
# zamba2-style hybrid (mamba2 + one shared attention block)
# ---------------------------------------------------------------------------

class SharedAttn(nn.Module):
    def __init__(self, cfg: ArchConfig, mk: ParamMaker, dtype: torch.dtype):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg, mk)
        self.attn = Attention(cfg, mk, dtype)
        self.ln2 = Norm(cfg.d_model, cfg, mk)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg, mk, dtype)


def _hybrid_groups(cfg: ArchConfig) -> Tuple[int, int, int]:
    every = cfg.hybrid_attn_every
    n_groups = cfg.num_layers // every
    return every, n_groups, cfg.num_layers - n_groups * every


def hybrid_forward(params, cfg: ArchConfig, x: torch.Tensor,
                   positions: torch.Tensor):
    every, n_groups, rem = _hybrid_groups(cfg)
    mamba, shared = params.mamba, params.shared_attn

    def mamba_body(x, lp):
        return x + mamba2_block(norm(x, lp.ln, cfg), lp.m, cfg), _zero(x)

    def shared_body(x):
        h = norm(x, shared.ln1, cfg)
        x = x + attn_block(h, shared.attn, cfg, positions, causal=True)
        return x + mlp(norm(x, shared.ln2, cfg), shared.mlp, cfg)

    shared_body = _remat(shared_body, cfg)
    aux = _zero(x)
    for g in range(n_groups):
        x, a = _run_layers(mamba_body, x, mamba[g * every:(g + 1) * every],
                           cfg)
        x = shared_body(x)
        aux = aux + a
    if rem:
        x, a = _run_layers(mamba_body, x, mamba[n_groups * every:], cfg)
        aux = aux + a
    return x, aux


def hybrid_decode(params, cfg: ArchConfig, x: torch.Tensor,
                  caches: dict) -> Tuple[torch.Tensor, dict]:
    every, n_groups, rem = _hybrid_groups(cfg)
    mamba, shared = params.mamba, params.shared_attn

    def mamba_body(x, lp, c):
        y, c2 = mamba2_decode(norm(x, lp.ln, cfg), lp.m, cfg, c)
        return x + y, c2, None

    for g in range(n_groups):
        x = _run_layers_cache(mamba_body, x, mamba[g * every:(g + 1) * every],
                              caches["mamba"], _ssm_at, g * every)
        h = norm(x, shared.ln1, cfg)
        a, _ = attn_decode(h, shared.attn, cfg, _kv_at(caches["attn"], g))
        x = x + a
        x = x + mlp(norm(x, shared.ln2, cfg), shared.mlp, cfg)
    if rem:
        x = _run_layers_cache(mamba_body, x, mamba[n_groups * every:],
                              caches["mamba"], _ssm_at, n_groups * every)
    return x, {"mamba": caches["mamba"], "attn": _advanced(caches["attn"])}


# ---------------------------------------------------------------------------
# whisper-style encoder-decoder
# ---------------------------------------------------------------------------

class EncoderLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, mk: ParamMaker, dtype: torch.dtype):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg, mk)
        self.attn = Attention(cfg, mk, dtype)
        self.ln2 = Norm(cfg.d_model, cfg, mk)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg, mk, dtype)


class CrossDecoderLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, mk: ParamMaker, dtype: torch.dtype):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg, mk)
        self.self_attn = Attention(cfg, mk, dtype)
        self.ln_x = Norm(cfg.d_model, cfg, mk)
        self.cross_attn = Attention(cfg, mk, dtype)
        self.ln2 = Norm(cfg.d_model, cfg, mk)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg, mk, dtype)


def encdec_forward(params, cfg: ArchConfig, enc_embeds: torch.Tensor,
                   dec_x: torch.Tensor, enc_positions: torch.Tensor,
                   dec_positions: torch.Tensor):
    """Returns (decoder hidden states, aux)."""

    def enc_body(x, lp):
        h = norm(x, lp.ln1, cfg)
        x = x + attn_block(h, lp.attn, cfg, enc_positions, causal=False)
        return x + mlp(norm(x, lp.ln2, cfg), lp.mlp, cfg), _zero(x)

    enc, _ = _run_layers(enc_body, enc_embeds, params.encoder, cfg)
    enc = norm(enc, params.enc_norm, cfg)

    def dec_body(x, lp):
        h = norm(x, lp.ln1, cfg)
        x = x + attn_block(h, lp.self_attn, cfg, dec_positions, causal=True)
        h2 = norm(x, lp.ln_x, cfg)
        kv = cross_kv(enc, lp.cross_attn, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
        x = x + attn_block(h2, lp.cross_attn, cfg, dec_positions,
                           cross_kv=kv)
        return x + mlp(norm(x, lp.ln2, cfg), lp.mlp, cfg), _zero(x)

    return _run_layers(dec_body, dec_x, params.decoder, cfg)


def encdec_decode(params, cfg: ArchConfig, x: torch.Tensor,
                  caches: dict) -> Tuple[torch.Tensor, dict]:
    """caches: {"self": stacked KVCache, "cross_k"/"cross_v": (L, B, S_enc,
    KVH, D)}."""
    zero_pos = torch.zeros((x.shape[0], 1), dtype=torch.int32,
                           device=x.device)
    for i, lp in enumerate(params.decoder):
        h = norm(x, lp.ln1, cfg)
        a, _ = attn_decode(h, lp.self_attn, cfg, _kv_at(caches["self"], i))
        x = x + a
        h2 = norm(x, lp.ln_x, cfg)
        x = x + attn_block(h2, lp.cross_attn, cfg, zero_pos,
                           cross_kv=(caches["cross_k"][i],
                                     caches["cross_v"][i]))
        x = x + mlp(norm(x, lp.ln2, cfg), lp.mlp, cfg)
    return x, {**caches, "self": _advanced(caches["self"])}
