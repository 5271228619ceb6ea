"""Mixture-of-Experts layer (``repro/models/moe.py``): grok-1 (8 experts,
top-2) and arctic (128 experts, top-2, plus a dense residual MLP), with
the reference's group-local capacity dispatch.

Tokens are dispatched per group of ``ts`` tokens (``group_size`` when it
divides the token count, else all of them) to at most
``cap = max(1, round(ts * k * cf / e))`` slots per expert, in token
order; the slot positions are one-hot cumulative sums held in float32 as
the reference holds them. ``top_k`` breaks ties toward the lower expert
index, as ``jax.lax.top_k`` does, so the dispatch, keep and drop
decisions equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import ParamMaker, _act


class MoE(nn.Module):
    def __init__(self, cfg: ArchConfig, mk: ParamMaker, dtype: torch.dtype):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
        self.router = mk.normal((d, e), d ** -0.5, torch.float32)
        self.w_gate = mk.normal((e, d, f), d ** -0.5, dtype)
        self.w_up = mk.normal((e, d, f), d ** -0.5, dtype)
        self.w_down = mk.normal((e, f, d), f ** -0.5, dtype)


class Route(NamedTuple):
    """One dispatch: per group g, token t and choice k."""

    logits: torch.Tensor  # (g, ts, e) float32 router logits
    probs: torch.Tensor  # (g, ts, e)
    gate_idx: torch.Tensor  # (g, ts, k) int64 chosen experts
    gate_vals: torch.Tensor  # (g, ts, k) renormalised, 0 where dropped
    pos: torch.Tensor  # (g, ts, k) int32 slot within the expert's capacity
    keep: torch.Tensor  # (g, ts, k) bool: pos < cap
    cap: int


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index (a
    stable descending sort; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot; an index outside [0, n) gives a zero row, as
    ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def route(xg: torch.Tensor, router: torch.Tensor, cfg: ArchConfig) -> Route:
    """The router, top-k and capacity bookkeeping for xg (g, ts, d)."""
    m = cfg.moe
    e = m.num_experts
    ts = xg.shape[1]
    cap = int(max(1, round(ts * m.top_k * m.capacity_factor / e)))
    logits = torch.einsum("gtd,de->gte", xg.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, m.top_k)
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    # position of each (token, choice) within its expert's group capacity
    choice = _one_hot(gate_idx, e)  # (g, ts, k, e)
    flat = choice.reshape(xg.shape[0], ts * m.top_k, e)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(choice.shape)
    pos = torch.sum(pos_in_expert * choice, dim=-1).to(torch.int32)
    keep = pos < cap
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    return Route(logits, probs, gate_idx, gate_vals, pos, keep, cap)


def moe_block(x: torch.Tensor, params: MoE,
              cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D), aux loss ())."""
    m = cfg.moe
    b, s, d = x.shape
    e = m.num_experts
    t = b * s
    ts = m.group_size if t % m.group_size == 0 else t
    xg = x.reshape(t // ts, ts, d)
    r = route(xg, params.router, cfg)
    choice = _one_hot(r.gate_idx, e)
    pos_onehot = _one_hot(r.pos, r.cap)  # (g, ts, k, cap)
    # dispatch / combine (g, ts, e, cap)
    dispatch = torch.einsum("gtke,gtkc->gtec",
                            choice * r.keep[..., None].to(torch.float32),
                            pos_onehot)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", choice, pos_onehot,
                           r.gate_vals)
    xe = torch.einsum("gtec,gtd->gecd", dispatch,
                      xg.to(torch.float32)).to(x.dtype)
    gate = _act(torch.einsum("gecd,edf->gecf", xe, params.w_gate), cfg.act)
    up = torch.einsum("gecd,edf->gecf", xe, params.w_up)
    ye = torch.einsum("gecf,efd->gecd", gate * up, params.w_down)
    y = torch.einsum("gtec,gecd->gtd", combine,
                     ye.to(torch.float32)).to(x.dtype)
    # aux losses: load balance (Switch) + router z-loss
    density = torch.mean(choice[:, :, 0, :], dim=(0, 1))
    density_proxy = torch.mean(r.probs, dim=(0, 1))
    aux = torch.sum(density * density_proxy) * (e ** 2) * m.aux_loss
    z = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2) * m.router_z_loss
    return y.reshape(b, s, d), aux + z
