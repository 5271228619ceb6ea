"""State-space blocks (``repro/models/ssm.py``): Mamba1 (falcon-mamba-7b)
and Mamba2/SSD (zamba2).

Mamba1 runs the exact sequential selective scan over L with a float32
state; Mamba2 the chunked SSD form (intra-chunk quadratic, inter-chunk
state recurrence), padding L internally to a multiple of ``chunk``. Both
have one-token decode steps over an ``SSMCache``. The causal convolution
is a sum over the kernel's k shifted slices, in the reference's order,
so the float sums match.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import ParamMaker, rmsnorm
from repro_torch.sharding.dtensor import run_local


class SSMCache(NamedTuple):
    conv: torch.Tensor  # (B, conv_dim - 1, channels) rolling conv inputs
    state: torch.Tensor  # mamba1: (B, d_inner, N); mamba2: (B, H, N, P)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over L: x (B, L, C), w (K, C), b (C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    return out + b


def d_inner_of(cfg: ArchConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def dt_rank_of(cfg: ArchConfig) -> int:
    return cfg.ssm.dt_rank or math.ceil(cfg.d_model / 16)


def _advance(cache: SSMCache, conv_in: torch.Tensor,
             state: torch.Tensor) -> SSMCache:
    """Write the step's conv window and state into the cache in place."""
    cache.conv.copy_(conv_in[:, 1:])
    cache.state.copy_(state)
    return cache


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------

class Mamba1(nn.Module):
    def __init__(self, cfg: ArchConfig, mk: ParamMaker, dtype: torch.dtype):
        super().__init__()
        c = cfg.ssm
        d = cfg.d_model
        di = d_inner_of(cfg)
        r = dt_rank_of(cfg)
        n = c.state_dim
        dev = mk.device
        self.in_proj = mk.normal((d, 2 * di), d ** -0.5, dtype)
        self.conv_w = mk.normal((c.conv_dim, di), 0.1, dtype)
        self.conv_b = mk.full((di,), 0.0, dtype)
        self.x_proj = mk.normal((di, r + 2 * n), di ** -0.5, dtype)
        self.dt_proj = mk.normal((r, di), r ** -0.5, dtype)
        # softplus^-1 of a log-uniform dt in [1e-3, 1e-1]
        u = mk.uniform((di,), math.log(1e-3), math.log(1e-1))
        self.dt_bias = mk.value(torch.log(torch.exp(torch.exp(u)) - 1.0))
        self.a_log = mk.value(torch.log(
            torch.arange(1, n + 1, dtype=torch.float32, device=dev)
            .expand(di, n).contiguous()))
        self.d = mk.full((di,), 1.0)
        self.out_proj = mk.normal((di, d), di ** -0.5, dtype)


def _dt(dt_r: torch.Tensor, params: Mamba1) -> torch.Tensor:
    return F.softplus(
        torch.einsum("blr,rd->bld", dt_r, params.dt_proj.to(torch.float32))
        + params.dt_bias)


def _selective_scan(da: torch.Tensor, dbx: torch.Tensor,
                    cmat: torch.Tensor) -> torch.Tensor:
    """The exact sequential scan: da, dbx (B, L, di, N), cmat (B, L, N)
    -> y (B, L, di), with a float32 state."""
    b, l, di, n = da.shape
    h = torch.zeros((b, di, n), dtype=torch.float32, device=da.device)
    ys = []
    for i in range(l):
        h = da[:, i] * h + dbx[:, i]
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, i]))
    return torch.stack(ys, dim=1)


def _mamba1_core(x: torch.Tensor, z: torch.Tensor, params: Mamba1,
                 cfg: ArchConfig) -> torch.Tensor:
    """Selective scan; x, z (B, L, di)."""
    n = cfg.ssm.state_dim
    r = dt_rank_of(cfg)
    xdbc = torch.matmul(x, params.x_proj).to(torch.float32)
    dt_r, bmat, cmat = torch.split(xdbc, [r, n, n], dim=-1)
    dt = _dt(dt_r, params)  # (B, L, di)
    a = -torch.exp(params.a_log)  # (di, N)
    da = torch.exp(dt[..., None] * a)  # (B, L, di, N) discretised A
    dbx = dt[..., None] * bmat[:, :, None, :] \
        * x.to(torch.float32)[..., None]
    # per sequence: on DTensors each device scans its batch shard
    y = run_local(_selective_scan, da, dbx, cmat)  # (B, L, di)
    y = y + params.d * x.to(torch.float32)
    y = y * F.silu(z.to(torch.float32))
    return y.to(x.dtype)


def mamba1_block(x: torch.Tensor, params: Mamba1,
                 cfg: ArchConfig) -> torch.Tensor:
    xi, z = torch.chunk(torch.matmul(x, params.in_proj), 2, dim=-1)
    xi = F.silu(_causal_conv(xi, params.conv_w, params.conv_b))
    y = _mamba1_core(xi, z, params, cfg)
    return torch.matmul(y, params.out_proj)


def mamba1_decode(x: torch.Tensor, params: Mamba1, cfg: ArchConfig,
                  cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """One-token step, x (B, 1, D); the cache is advanced in place."""
    n = cfg.ssm.state_dim
    r = dt_rank_of(cfg)
    xi, z = torch.chunk(torch.matmul(x, params.in_proj), 2, dim=-1)
    conv_in = torch.cat([cache.conv, xi], dim=1)  # (B, K, di)
    xi = torch.einsum("bkd,kd->bd", conv_in, params.conv_w)[:, None, :] \
        + params.conv_b
    xi = F.silu(xi)
    xdbc = torch.matmul(xi, params.x_proj).to(torch.float32)
    dt_r, bmat, cmat = torch.split(xdbc, [r, n, n], dim=-1)
    dt = _dt(dt_r, params)[:, 0]  # (B, di)
    a = -torch.exp(params.a_log)
    da = torch.exp(dt[..., None] * a)  # (B, di, N)
    h = da * cache.state + dt[..., None] * bmat[:, 0, None, :] \
        * xi.to(torch.float32)[:, 0, :, None]
    y = torch.einsum("bdn,bn->bd", h, cmat[:, 0])[:, None, :]
    y = y + params.d * xi.to(torch.float32)
    y = y * F.silu(z.to(torch.float32))
    out = torch.matmul(y.to(x.dtype), params.out_proj)
    return out, _advance(cache, conv_in, h)


# ---------------------------------------------------------------------------
# Mamba2 (SSD chunked form)
# ---------------------------------------------------------------------------

class Mamba2(nn.Module):
    def __init__(self, cfg: ArchConfig, mk: ParamMaker, dtype: torch.dtype):
        super().__init__()
        c = cfg.ssm
        d = cfg.d_model
        di = d_inner_of(cfg)
        h = di // c.head_dim
        n = c.state_dim
        # projects to [z, x, B, C, dt]
        self.in_proj = mk.normal((d, 2 * di + 2 * n + h), d ** -0.5, dtype)
        self.conv_w = mk.normal((c.conv_dim, di + 2 * n), 0.1, dtype)
        self.conv_b = mk.full((di + 2 * n,), 0.0, dtype)
        self.a_log_h = mk.value(torch.log(
            torch.linspace(1.0, 16.0, h, device=mk.device)))
        self.dt_bias_h = mk.full((h,), 0.0)
        self.d_h = mk.full((h,), 1.0)
        self.norm_scale = mk.full((di,), 0.0)
        self.out_proj = mk.normal((di, d), di ** -0.5, dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """exp-safe segment sum: out[..., i, j] = sum a[..., j+1..i] for
    i >= j, -inf above the diagonal."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -math.inf)


def _mamba2_split(proj: torch.Tensor, cfg: ArchConfig):
    di = d_inner_of(cfg)
    n = cfg.ssm.state_dim
    return torch.split(proj, [di, di + 2 * n, proj.shape[-1] - 2 * di - 2 * n],
                       dim=-1)


def mamba2_block(x: torch.Tensor, params: Mamba2,
                 cfg: ArchConfig) -> torch.Tensor:
    """Chunked SSD, x (B, L, D); L padded internally to a chunk multiple
    (causality makes the trailing zero pad inert for real positions)."""
    c = cfg.ssm
    di = d_inner_of(cfg)
    p = c.head_dim
    h = di // p
    n = c.state_dim
    cl = c.chunk
    b, l_in, _ = x.shape
    pad = (-l_in) % cl
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    l = l_in + pad
    nc = l // cl

    z, xbc, dt_raw = _mamba2_split(torch.matmul(x, params.in_proj), cfg)
    xbc = F.silu(_causal_conv(xbc, params.conv_w, params.conv_b))
    xs, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    xs = xs.reshape(b, l, h, p)
    dt = F.softplus(dt_raw.to(torch.float32) + params.dt_bias_h)  # (B, L, H)
    a = -torch.exp(params.a_log_h)  # (H,)
    da = dt * a  # (B, L, H) log-decay per step

    # chunked views
    dac = da.reshape(b, nc, cl, h).permute(0, 1, 3, 2)  # (B, nc, H, cl)
    xc = xs.reshape(b, nc, cl, h, p).to(torch.float32)
    bc = bmat.reshape(b, nc, cl, n).to(torch.float32)
    cc = cmat.reshape(b, nc, cl, n).to(torch.float32)
    dtc = dt.reshape(b, nc, cl, h)

    # per sequence: on DTensors each device runs its batch shard
    y = run_local(_ssd, dac, xc, bc, cc, dtc).reshape(b, l, h, p)
    y = y + params.d_h[None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(b, l, di) * F.silu(z.to(torch.float32))
    if pad:
        y = y[:, :l_in]
    # group norm (simplified to rmsnorm over di, as the reference)
    y = rmsnorm(y.to(x.dtype), params.norm_scale, cfg.norm_eps)
    return torch.matmul(y, params.out_proj)


def _ssd(dac: torch.Tensor, xc: torch.Tensor, bc: torch.Tensor,
         cc: torch.Tensor, dtc: torch.Tensor) -> torch.Tensor:
    """The chunked SSD core: dac (B, nc, H, cl) log-decays, xc (B, nc, cl,
    H, P), bc and cc (B, nc, cl, N), dtc (B, nc, cl, H) -> the output
    (B, nc, cl, H, P) before the skip term."""
    b, nc, h, _ = dac.shape
    n, p = bc.shape[-1], xc.shape[-1]
    # 1) intra-chunk (quadratic): Y_diag = (L o C B^T) . (dt x)
    lmat = torch.exp(_segsum(dac))  # (B, nc, H, cl, cl)
    cb = torch.einsum("bzin,bzjn->bzij", cc, bc)  # (B, nc, cl, cl)
    w = cb[:, :, None] * lmat
    y_diag = torch.einsum("bzhij,bzjh,bzjhp->bzihp", w, dtc, xc)

    # 2) chunk end states: S_z = sum_j exp(sum_{j+1..end} a) dt_j B_j x_j^T
    a_cum = torch.cumsum(dac, dim=-1)  # (B, nc, H, cl)
    a_total = a_cum[..., -1:]  # (B, nc, H, 1)
    decay_to_end = torch.exp(a_total - a_cum)
    s_chunk = torch.einsum("bzhj,bzjh,bzjn,bzjhp->bzhnp", decay_to_end, dtc,
                           bc, xc)  # (B, nc, H, N, P)

    # 3) inter-chunk recurrence: the state entering each chunk
    s = torch.zeros((b, h, n, p), dtype=torch.float32, device=dac.device)
    s_prev = []
    for zi in range(nc):
        s_prev.append(s)
        s = torch.exp(a_total[:, zi, :, 0])[..., None, None] * s \
            + s_chunk[:, zi]
    s_prev = torch.stack(s_prev, dim=1)  # (B, nc, H, N, P)

    # 4) inter-chunk contribution: Y_off = exp(a_cum) C . S_prev
    y_off = torch.einsum("bzhi,bzin,bzhnp->bzihp", torch.exp(a_cum), cc,
                         s_prev)
    return y_diag + y_off


def mamba2_decode(x: torch.Tensor, params: Mamba2, cfg: ArchConfig,
                  cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """One-token step, x (B, 1, D); the cache is advanced in place."""
    c = cfg.ssm
    di = d_inner_of(cfg)
    p = c.head_dim
    h = di // p
    n = c.state_dim
    b = x.shape[0]
    z, xbc, dt_raw = _mamba2_split(torch.matmul(x, params.in_proj), cfg)
    conv_in = torch.cat([cache.conv, xbc], dim=1)
    xbc = torch.einsum("bkd,kd->bd", conv_in, params.conv_w)[:, None, :] \
        + params.conv_b
    xbc = F.silu(xbc)
    xs, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    xs = xs.reshape(b, h, p)
    dt = F.softplus(dt_raw[:, 0].to(torch.float32) + params.dt_bias_h)
    a = -torch.exp(params.a_log_h)
    decay = torch.exp(dt * a)  # (B, H)
    s = decay[..., None, None] * cache.state + torch.einsum(
        "bh,bn,bhp->bhnp", dt, bmat[:, 0].to(torch.float32),
        xs.to(torch.float32))
    y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].to(torch.float32), s)
    y = y + params.d_h[None, :, None] * xs.to(torch.float32)
    y = y.reshape(b, 1, di) * F.silu(z.to(torch.float32))
    y = rmsnorm(y.to(x.dtype), params.norm_scale, cfg.norm_eps)
    out = torch.matmul(y, params.out_proj)
    return out, _advance(cache, conv_in, s)
