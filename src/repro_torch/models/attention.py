"""Attention flavours of the zoo (``repro/models/attention.py``): GQA
(+bias, +qk-norm), sliding window, MLA (latent attention), and cached
decode.

q·k and p·v run in float32 and the result is cast back, as the reference
computes them. The mask is an additive -1e30 bias. Cached decode writes
the new token's K/V into the cache tensors in place (the caller hands
its cache over, as the reference's jitted step donates it) at the slot
``jax.lax.dynamic_update_slice`` would write: a position past the end
clamps to the last slot instead of failing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    ParamMaker,
    apply_mrope,
    apply_rope,
    rmsnorm,
)
from repro_torch.sharding.dtensor import (
    is_dtensor,
    merge_dims,
    split_dim,
    write_slot,
)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KVH, D), or MLA: (B, S_max, 1, c_kv+rope)
    v: Optional[torch.Tensor]  # None for MLA (the latent holds both)
    length: torch.Tensor  # () int32: tokens currently valid


def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
               window: int,
               kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive mask (B, 1, Sq, Skv): 0 where attended, -1e30 elsewhere."""
    dq = q_pos[:, :, None]
    dk = kv_pos[:, None, :]
    # built from the positions (not a fresh tensor of the global shape), so
    # batch-sharded DTensor positions give a batch-sharded mask
    ok = torch.ones_like(dq, dtype=torch.bool).expand(
        dq.shape[0], dq.shape[1], dk.shape[2])
    if causal:
        ok = ok & (dk <= dq)
    if window > 0:
        ok = ok & (dk > dq - window)
    if kv_valid is not None:
        ok = ok & kv_valid[:, None, :]
    bias = torch.zeros_like(ok, dtype=torch.float32,
                            memory_format=torch.contiguous_format)
    return bias.masked_fill_(~ok, -1e30)[:, None, :, :]


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask_bias: torch.Tensor,
           scale: Optional[float] = None) -> torch.Tensor:
    """GQA core: q (B, Sq, H, D), k (B, Skv, KVH, D), v (B, Skv, KVH, Dv);
    H a multiple of KVH, the heads grouped as (KVH, H / KVH)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qg = split_dim(q, 2, (kvh, groups))
    logits = torch.einsum("bqhgd,bkhd->bhgqk",
                          qg.to(torch.float32) * scale, k.to(torch.float32))
    logits = logits + mask_bias[:, :, None, :, :]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhe->bqhge", probs, v.to(torch.float32))
    return merge_dims(out, 2, 2).to(q.dtype)


def _write_slot(cache: torch.Tensor, new: torch.Tensor,
                slot: torch.Tensor) -> None:
    """``cache[:, slot] = new[:, 0]`` in place, ``slot`` clamped into
    [0, S_max - 1] as ``dynamic_update_slice`` clamps its start."""
    idx = torch.clamp(slot, 0, cache.shape[1] - 1).reshape(1).long()
    if is_dtensor(cache):
        write_slot(cache, new, idx)
        return
    cache.index_copy_(1, idx, new.to(cache.dtype))


# ---------------------------------------------------------------------------
# standard (GQA) attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """Flat projection layouts (d, h*hd), as the reference's."""

    def __init__(self, cfg: ArchConfig, mk: ParamMaker, dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        hd = cfg.resolved_head_dim
        h, kvh = cfg.num_heads, cfg.num_kv_heads
        s = d ** -0.5
        self.wq = mk.normal((d, h * hd), s, dtype)
        self.wk = mk.normal((d, kvh * hd), s, dtype)
        self.wv = mk.normal((d, kvh * hd), s, dtype)
        self.wo = mk.normal((h * hd, d), (h * hd) ** -0.5, dtype)
        if cfg.qkv_bias:
            self.bq = mk.full((h * hd,), 0.0, dtype)
            self.bk = mk.full((kvh * hd,), 0.0, dtype)
            self.bv = mk.full((kvh * hd,), 0.0, dtype)
        if cfg.qk_norm:
            self.q_norm = mk.full((hd,), 0.0)
            self.k_norm = mk.full((hd,), 0.0)


def _qkv(x: torch.Tensor, params: Attention, cfg: ArchConfig,
         positions: torch.Tensor, theta: float):
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.matmul(x, params.wq)
    k = torch.matmul(x, params.wk)
    v = torch.matmul(x, params.wv)
    if cfg.qkv_bias:
        q = q + params.bq
        k = k + params.bk
        v = v + params.bv
    q = split_dim(q, -1, (h, hd))
    k = split_dim(k, -1, (kvh, hd))
    v = split_dim(v, -1, (kvh, hd))
    if cfg.qk_norm:
        q = rmsnorm(q, params.q_norm, cfg.norm_eps)
        k = rmsnorm(k, params.k_norm, cfg.norm_eps)
    if cfg.mrope:
        if positions.ndim == 2:  # text-only stream: t == h == w
            positions = positions[..., None].expand(*positions.shape, 3)
        q = apply_mrope(q, positions, theta)
        k = apply_mrope(k, positions, theta)
    else:
        pos = positions if positions.ndim == 2 else positions[..., 0]
        q = apply_rope(q, pos, theta)
        k = apply_rope(k, pos, theta)
    return q, k, v


def attn_block(x: torch.Tensor, params: Attention, cfg: ArchConfig,
               positions: torch.Tensor, *, causal: bool = True,
               window: int = 0, theta: Optional[float] = None,
               cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """Full-sequence attention (train / prefill); with ``cross_kv`` the
    queries attend the given encoder K/V, unmasked and without RoPE."""
    theta = theta if theta is not None else cfg.rope_theta
    pos2d = positions if positions.ndim == 2 else positions[..., 0]
    if cross_kv is None:
        q, k, v = _qkv(x, params, cfg, positions, theta)
        bias = _mask_bias(pos2d, pos2d, causal, window)
    else:
        b, s, _ = x.shape
        q = torch.matmul(x, params.wq)
        if cfg.qkv_bias:
            q = q + params.bq
        q = q.reshape(b, s, cfg.num_heads, cfg.resolved_head_dim)
        k, v = cross_kv
        bias = torch.zeros((b, 1, s, k.shape[1]), dtype=torch.float32,
                           device=x.device)
    out = attend(q, k, v, bias)
    b, sq = out.shape[:2]
    return torch.matmul(out.reshape(b, sq, -1), params.wo)


def cross_kv(enc: torch.Tensor, params: Attention, kvh: int,
             hd: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder-side K/V projections for cross-attention (whisper)."""
    b, s, _ = enc.shape
    k = torch.matmul(enc, params.wk).reshape(b, s, kvh, hd)
    v = torch.matmul(enc, params.wv).reshape(b, s, kvh, hd)
    return k, v


def attn_decode(x: torch.Tensor, params: Attention, cfg: ArchConfig,
                cache: KVCache, *, window: int = 0,
                theta: Optional[float] = None
                ) -> Tuple[torch.Tensor, KVCache]:
    """One-token cached decode, x (B, 1, D). A cache of exactly ``window``
    slots is a ring: the token goes to slot ``pos % window``."""
    theta = theta if theta is not None else cfg.rope_theta
    b = x.shape[0]
    pos = cache.length  # () current position
    positions = pos.reshape(1, 1).expand(b, 1)
    q, k_new, v_new = _qkv(x, params, cfg, positions, theta)
    s_max = cache.k.shape[1]
    ring = window > 0 and s_max == window
    slot = torch.remainder(pos, window) if ring else pos
    _write_slot(cache.k, k_new, slot)
    _write_slot(cache.v, v_new, slot)
    kv_pos = torch.arange(s_max, dtype=torch.int32,
                          device=x.device)[None, :].expand(b, s_max)
    if ring:
        valid = kv_pos < torch.clamp(pos + 1, max=window)
    else:
        valid = kv_pos <= pos
    bias = _mask_bias(positions, kv_pos, False, 0, valid)
    out = attend(q, cache.k, cache.v, bias)
    out = torch.matmul(out.reshape(b, 1, -1), params.wo)
    return out, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (MiniCPM3)
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    def __init__(self, cfg: ArchConfig, mk: ParamMaker, dtype: torch.dtype):
        super().__init__()
        m = cfg.mla
        d, h = cfg.d_model, cfg.num_heads
        s = d ** -0.5
        qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
        # query low-rank path
        self.wq_a = mk.normal((d, m.q_lora_rank), s, dtype)
        self.q_a_norm = mk.full((m.q_lora_rank,), 0.0)
        self.wq_b = mk.normal((m.q_lora_rank, h * qk_head),
                              m.q_lora_rank ** -0.5, dtype)
        # kv latent path: compressed c_kv plus the shared rope key channel
        self.wkv_a = mk.normal((d, m.kv_lora_rank + m.qk_rope_head_dim), s,
                               dtype)
        self.kv_a_norm = mk.full((m.kv_lora_rank,), 0.0)
        self.wkv_b = mk.normal(
            (m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)),
            m.kv_lora_rank ** -0.5, dtype)
        self.wo = mk.normal((h * m.v_head_dim, d),
                            (h * m.v_head_dim) ** -0.5, dtype)


def _mla_queries(x, params: MLA, cfg: ArchConfig, pos2d):
    m = cfg.mla
    b, sl, _ = x.shape
    q_lat = rmsnorm(torch.matmul(x, params.wq_a), params.q_a_norm,
                    cfg.norm_eps)
    q = torch.matmul(q_lat, params.wq_b).reshape(
        b, sl, cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, pos2d, cfg.rope_theta)
    return torch.cat([q_nope, q_rope], dim=-1)


def _mla_kv(c_kv, k_rope, params: MLA, cfg: ArchConfig):
    """Expand latents (B, S, r) and rope keys (B, S, 1, R) into per-head
    K and V (the dense expansion, as the reference)."""
    m = cfg.mla
    b, sl, _ = c_kv.shape
    kv = torch.matmul(c_kv, params.wkv_b).reshape(
        b, sl, cfg.num_heads, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = torch.split(kv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3],
                                         m.qk_rope_head_dim)], dim=-1)
    return k, v


def mla_block(x: torch.Tensor, params: MLA, cfg: ArchConfig,
              positions: torch.Tensor, *, causal: bool = True
              ) -> torch.Tensor:
    """MLA attention (train / prefill); the decode cache holds only the
    latent (``mla_decode``)."""
    m = cfg.mla
    pos2d = positions if positions.ndim == 2 else positions[..., 0]
    b, sl, _ = x.shape
    qfull = _mla_queries(x, params, cfg, pos2d)
    kv_a = torch.matmul(x, params.wkv_a)
    c_kv, k_rope = torch.split(kv_a, [m.kv_lora_rank, m.qk_rope_head_dim],
                               dim=-1)
    c_kv = rmsnorm(c_kv, params.kv_a_norm, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], pos2d, cfg.rope_theta)
    k, v = _mla_kv(c_kv, k_rope, params, cfg)
    bias = _mask_bias(pos2d, pos2d, causal, 0)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    out = attend(qfull, k, v, bias, scale=scale)
    return torch.matmul(out.reshape(b, sl, -1), params.wo)


def mla_decode(x: torch.Tensor, params: MLA, cfg: ArchConfig,
               cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """cache.k: (B, S_max, 1, kv_lora + rope) latents; cache.v None."""
    m = cfg.mla
    b = x.shape[0]
    pos = cache.length
    positions = pos.reshape(1, 1).expand(b, 1)
    kv_a = torch.matmul(x, params.wkv_a)
    c_new, krope_new = torch.split(
        kv_a, [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_new = rmsnorm(c_new, params.kv_a_norm, cfg.norm_eps)
    krope_new = apply_rope(krope_new[:, :, None, :], positions,
                           cfg.rope_theta)
    _write_slot(cache.k, torch.cat([c_new[:, :, None, :], krope_new], -1),
                pos)
    lat = cache.k
    s_max = lat.shape[1]
    c_all, krope_all = torch.split(
        lat[:, :, 0, :], [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    k, v = _mla_kv(c_all, krope_all[:, :, None, :], params, cfg)
    qfull = _mla_queries(x, params, cfg, positions)
    kv_pos = torch.arange(s_max, dtype=torch.int32,
                          device=x.device)[None, :].expand(b, s_max)
    bias = _mask_bias(positions, kv_pos, False, 0, kv_pos <= pos)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    out = attend(qfull, k, v, bias, scale=scale)
    out = torch.matmul(out.reshape(b, 1, -1), params.wo)
    return out, KVCache(k=lat, v=None, length=cache.length + 1)
