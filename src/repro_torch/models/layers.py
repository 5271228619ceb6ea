"""Shared LM layers (``repro/models/layers.py``): norms, RoPE (+M-RoPE),
MLPs, embedding, and the parameter maker every module draws its leaves
from.

A module's parameters carry the reference's pytree key names (``wq``,
``ln1.scale``, ...), so ``models.convert`` maps the two trees name for
name. The arithmetic keeps the reference's order and precision: norms and
RoPE in float32 and cast back, products in the parameters' dtype.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding.dtensor import (
    as_activation,
    embed_rows,
    is_split,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class ParamMaker:
    """Makes a model's leaves on ``device``. With a ``generator`` they are
    drawn as the reference draws them (N(0, 1) or U(lo, hi) in float32,
    scaled, then cast); without one (a ``meta`` device, or a tree about to
    be loaded by ``models.convert``) they are left uninitialised. Every
    leaf is an ``nn.Parameter`` made frozen, as serving wants it;
    ``train.train_step.init_train_state`` makes a model's leaves
    trainable (``requires_grad_(True)``)."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        self.generator = generator

    @property
    def draws(self) -> bool:
        return self.generator is not None and self.device.type != "meta"

    def _leaf(self, t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t, requires_grad=False)

    def _empty(self, shape, dtype) -> nn.Parameter:
        return self._leaf(torch.empty(tuple(shape), dtype=dtype,
                                      device=self.device))

    def normal(self, shape: Sequence[int], scale: float,
               dtype: torch.dtype) -> nn.Parameter:
        if not self.draws:
            return self._empty(shape, dtype)
        t = torch.randn(tuple(shape), generator=self.generator,
                        device=self.device, dtype=torch.float32)
        return self._leaf((t * scale).to(dtype))

    def uniform(self, shape: Sequence[int], lo: float,
                hi: float) -> torch.Tensor:
        """A float32 U(lo, hi) draw, for leaves computed from one."""
        if not self.draws:
            return torch.empty(tuple(shape), device=self.device)
        t = torch.rand(tuple(shape), generator=self.generator,
                       device=self.device, dtype=torch.float32)
        return t * (hi - lo) + lo

    def full(self, shape: Sequence[int], value: float,
             dtype: torch.dtype = torch.float32) -> nn.Parameter:
        if not self.draws:
            return self._empty(shape, dtype)
        return self._leaf(torch.full(tuple(shape), value, dtype=dtype,
                                     device=self.device))

    def value(self, t: torch.Tensor) -> nn.Parameter:
        """A leaf computed by the caller (``t`` on this device)."""
        if not self.draws:
            return self._empty(t.shape, t.dtype)
        return self._leaf(t)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """The scale is stored as an offset: ``x / rms(x) * (1 + scale)``,
    computed in float32."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


class Norm(nn.Module):
    """RMSNorm (``scale`` zeros: the offset form) or LayerNorm (``scale``
    ones, ``bias`` zeros), float32 leaves."""

    def __init__(self, d: int, cfg: ArchConfig, mk: ParamMaker):
        super().__init__()
        self.layer = cfg.norm_style == "layernorm"
        self.eps = cfg.norm_eps
        if self.layer:
            self.scale = mk.full((d,), 1.0)
            self.bias = mk.full((d,), 0.0)
        else:
            self.scale = mk.full((d,), 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.layer:
            return layernorm(x, self.scale, self.bias, self.eps)
        return rmsnorm(x, self.scale, self.eps)


def norm(x: torch.Tensor, params: Norm, cfg: ArchConfig) -> torch.Tensor:
    return params(x)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Half-split rotation (not interleaved) by (B, S, D/2) angles."""
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=(2, 1, 1)) -> torch.Tensor:
    """Multimodal RoPE: positions (B, S, 3) (temporal, height, width); the
    rope channel groups (sections of the half width) take their angle from
    one component each. Text tokens have t == h == w, so M-RoPE == RoPE."""
    d = x.shape[-1]
    half = d // 2
    total = sum(sections)
    split = [half * s // total for s in sections]
    split[-1] = half - sum(split[:-1])
    freqs = rope_freqs(d, theta, x.device)
    comp = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                      for i, n in enumerate(split)])
    pos = positions.to(torch.float32)[:, :, comp]  # (B, S, half)
    return _rotate(x, pos * freqs)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


class MLP(nn.Module):
    """Gated (SwiGLU-style, ``w_gate``) or plain 2-layer MLP."""

    def __init__(self, d_model: int, d_ff: int, cfg: ArchConfig,
                 mk: ParamMaker, dtype: torch.dtype):
        super().__init__()
        self.glu, self.act = cfg.glu, cfg.act
        # the reference draws gate, up, down from three keys; here one
        # generator in the order the leaves are listed
        if cfg.glu:
            self.w_gate = mk.normal((d_model, d_ff), d_model ** -0.5, dtype)
        self.w_up = mk.normal((d_model, d_ff), d_model ** -0.5, dtype)
        self.w_down = mk.normal((d_ff, d_model), d_ff ** -0.5, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.glu:
            gate = _act(torch.matmul(x, self.w_gate), self.act)
            up = torch.matmul(x, self.w_up)
            return torch.matmul(gate * up, self.w_down)
        h = _act(torch.matmul(x, self.w_up), self.act)
        return torch.matmul(h, self.w_down)


def mlp(x: torch.Tensor, params: MLP, cfg: ArchConfig) -> torch.Tensor:
    return params(x)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    if is_split(table):
        # each vocab shard looks up the rows it holds
        return embed_rows(table, tokens)
    return table[tokens.long()]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits against the (V, D) table (tied or a separate head); with a
    vocab-sharded DTensor table, vocab-sharded logits."""
    return torch.matmul(as_activation(x), table.t())
