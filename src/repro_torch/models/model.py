"""Public model API (``repro/models/model.py``): init, forward, decode and
cache construction.

``LM`` is the model: an ``nn.Module`` whose parameter names are the
reference's pytree paths (``layers.3.attn.wq`` is the reference's
``params["layers"]["attn"]["wq"][3]``). The reference's functions keep
their names as thin entry points taking the ``LM`` where the reference
takes its parameter tree. Families dispatch on the config:

  dense | moe | vlm   one decoder stack (gemma3's local:global pattern too)
  ssm                 mamba1 stack (falcon-mamba)
  hybrid              mamba2 + one shared attention block (zamba2)
  encdec              whisper encoder-decoder (stub frontend embeddings)

Everything runs on the card unless the caller asks for another device;
a ``meta`` device builds a full configuration without memory, to count
it. Decode writes the caches it is handed in place and returns them with
their lengths advanced. Cache construction, prefill and decode run under
``torch.no_grad()``: a trained model's in-place cache writes would
otherwise grow an autograd graph across decode steps.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    KVCache,
    _mask_bias,
    _qkv,
    attend,
    cross_kv,  # noqa: F401  (the reference's module surface)
)
from repro_torch.models.layers import (
    Norm,
    ParamMaker,
    dtype_of,
    embed,
    norm,
    unembed,
)
from repro_torch.models.ssm import SSMCache, d_inner_of
from repro_torch.models.transformer import (
    CrossDecoderLayer,
    DecoderLayer,
    EncoderLayer,
    SharedAttn,
    SSMLayer,
    _ffn,
    decoder_layer,  # noqa: F401  (the reference's module surface)
    decoder_layer_decode,  # noqa: F401
    dense_decode,
    dense_forward,
    encdec_decode,
    encdec_forward,
    hybrid_decode,
    hybrid_forward,
    pattern_counts,
    patterned_decode,
    patterned_forward,
    ssm_decode,
    ssm_forward,
)
from repro_torch.sharding.dtensor import (
    dtensor_scope,
    gather_last,
    is_split,
    like_batch,
)


def _stack(n: int, make) -> nn.ModuleList:
    return nn.ModuleList(make() for _ in range(n))


class LM(nn.Module):
    """Every family's parameters, in the reference's tree layout."""

    def __init__(self, cfg: ArchConfig, mk: ParamMaker):
        super().__init__()
        self.cfg = cfg
        dtype = dtype_of(cfg)
        v, d = cfg.padded_vocab_size, cfg.d_model
        self.embed = mk.normal((v, d), d ** -0.5, dtype)
        self.final_norm = Norm(d, cfg, mk)
        if not cfg.tie_embeddings:
            self.lm_head = mk.normal((v, d), d ** -0.5, dtype)

        def dec():
            return DecoderLayer(cfg, mk, dtype)

        if cfg.family in ("dense", "moe", "vlm"):
            if cfg.local_global_pattern:
                _, n_global, _ = pattern_counts(cfg)
                self.local = _stack(cfg.num_layers - n_global, dec)
                self.add_module("global", _stack(n_global, dec))
            else:
                self.layers = _stack(cfg.num_layers, dec)
        elif cfg.family == "ssm":
            self.layers = _stack(cfg.num_layers,
                                 lambda: SSMLayer(cfg, mk, dtype, 1))
        elif cfg.family == "hybrid":
            self.mamba = _stack(cfg.num_layers,
                                lambda: SSMLayer(cfg, mk, dtype, 2))
            self.shared_attn = SharedAttn(cfg, mk, dtype)
        elif cfg.family == "encdec":
            self.encoder = _stack(cfg.num_encoder_layers or cfg.num_layers,
                                  lambda: EncoderLayer(cfg, mk, dtype))
            self.enc_norm = Norm(d, cfg, mk)
            self.decoder = _stack(cfg.num_layers,
                                  lambda: CrossDecoderLayer(cfg, mk, dtype))
        else:
            raise ValueError(cfg.family)

    @property
    def head(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(rng: Union[int, torch.Generator], cfg: ArchConfig,
                device: Optional[Union[str, torch.device]] = None) -> LM:
    """A random ``LM`` with the reference's shapes and scales, drawn from
    ``rng`` (a seed, or a ``torch.Generator`` on ``device``), on the card
    unless asked otherwise; on ``meta`` nothing is drawn or allocated."""
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = rng if isinstance(rng, torch.Generator) \
            else torch.Generator(device=dev).manual_seed(int(rng))
    return LM(cfg, ParamMaker(dev, gen))


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _positions(b: int, s: int, cfg: ArchConfig,
               device: torch.device) -> torch.Tensor:
    base = torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)
    return base[..., None].expand(b, s, 3) if cfg.mrope else base


def forward(params: LM, cfg: ArchConfig,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: tokens (B, S), or embeds (B, S, D) from a
    stub frontend; positions (B, S), or (B, S, 3) for M-RoPE. Returns
    (logits (B, S, padded vocab), aux loss ())."""
    with dtensor_scope(params.embed):
        return _forward(params, cfg, tokens, embeds, positions, enc_embeds)


def _forward(params, cfg, tokens, embeds, positions, enc_embeds):
    x = embed(tokens, params.embed) if embeds is None else embeds
    b, s = x.shape[:2]
    if positions is None:
        positions = like_batch(_positions(b, s, cfg, x.device), x)
    if cfg.family == "encdec":
        assert enc_embeds is not None, "whisper needs frontend embeddings"
        ep = torch.arange(enc_embeds.shape[1], dtype=torch.int32,
                          device=x.device)[None].expand(enc_embeds.shape[:2])
        x, aux = encdec_forward(params, cfg, enc_embeds, x, ep, positions)
    elif cfg.family == "hybrid":
        x, aux = hybrid_forward(params, cfg, x, positions)
    elif cfg.family == "ssm":
        x, aux = ssm_forward(params, cfg, x)
    elif cfg.local_global_pattern:
        x, aux = patterned_forward(params, cfg, x, positions)
    else:
        x, aux = dense_forward(params, cfg, x, positions)
    x = norm(x, params.final_norm, cfg)
    return unembed(x, params.head), aux


def loss_fn(params: LM, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (+ MoE aux). Differentiable: the train
    step takes its gradients with ``torch.autograd.grad``. The gold logit
    is gathered, which equals the reference's one-hot contraction without
    a (B, S, V) one-hot."""
    logits, aux = forward(params, cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"),
                          positions=batch.get("positions"),
                          enc_embeds=batch.get("enc_embeds"))
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    logits = logits.to(torch.float32)
    if cfg.padded_vocab_size != cfg.vocab_size:
        # vocab-padding columns can never be predicted
        vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(vocab_ids >= cfg.vocab_size, -1e30)
    if is_split(logits):
        # vocab-sharded logits: logsumexp as its max and its sum of
        # exponentials, each reduced over the vocab shards (a (B, S)
        # all-reduce, where DTensor's own rule gathers the logits)
        top = torch.amax(logits, dim=-1, keepdim=True).detach()
        logz = torch.log(torch.sum(torch.exp(logits - top), dim=-1)) \
            + top[..., 0]
        gold = gather_last(logits, labels[..., None])[..., 0]
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp_min(torch.sum(mask), 1.0)
    else:
        denom = float(labels.numel())
    ce = torch.sum(nll) / denom
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_cache(cfg: ArchConfig, batch: int, s_max: int, length: int = 0,
               s_enc: int = 0,
               device: Optional[Union[str, torch.device]] = None) -> Any:
    """A zeroed decode cache in the reference's layout (stacked, a leading
    layer axis; every layer's ``length`` set to ``length``)."""
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    dtype = dtype_of(cfg)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def make(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def length_arr(n):
        return torch.full((n,), length, dtype=torch.int32, device=dev)

    def kv(n, s):
        return KVCache(k=make((n, batch, s, kvh, hd)),
                       v=make((n, batch, s, kvh, hd)), length=length_arr(n))

    if cfg.family in ("dense", "moe", "vlm") and not cfg.local_global_pattern:
        l = cfg.num_layers
        if cfg.mla is not None:
            lat = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
            return KVCache(k=make((l, batch, s_max, 1, lat)), v=None,
                           length=length_arr(l))
        return kv(l, s_max)
    if cfg.local_global_pattern:
        _, n_global, _ = pattern_counts(cfg)
        s_loc = min(cfg.sliding_window, s_max) if cfg.sliding_window \
            else s_max
        return {"local": kv(cfg.num_layers - n_global, s_loc),
                "global": kv(n_global, s_max)}
    if cfg.family == "ssm":
        l, di = cfg.num_layers, d_inner_of(cfg)
        return SSMCache(
            conv=make((l, batch, cfg.ssm.conv_dim - 1, di)),
            state=make((l, batch, di, cfg.ssm.state_dim), torch.float32))
    if cfg.family == "hybrid":
        l, di = cfg.num_layers, d_inner_of(cfg)
        h = di // cfg.ssm.head_dim
        n = cfg.ssm.state_dim
        return {
            "mamba": SSMCache(
                conv=make((l, batch, cfg.ssm.conv_dim - 1, di + 2 * n)),
                state=make((l, batch, h, n, cfg.ssm.head_dim),
                           torch.float32)),
            "attn": kv(l // cfg.hybrid_attn_every, s_max),
        }
    if cfg.family == "encdec":
        l = cfg.num_layers
        return {"self": kv(l, s_max),
                "cross_k": make((l, batch, s_enc, kvh, hd)),
                "cross_v": make((l, batch, s_enc, kvh, hd))}
    raise ValueError(cfg.family)


@torch.no_grad()
def decode_step(params: LM, cfg: ArchConfig, token: torch.Tensor,
                caches: Any) -> Tuple[torch.Tensor, Any]:
    """One cached decode step, token (B,). Returns (logits (B, vocab_size),
    the caches advanced)."""
    with dtensor_scope(params.embed):
        return _decode_step(params, cfg, token, caches)


def _decode_step(params, cfg, token, caches):
    x = embed(token[:, None], params.embed)
    if cfg.family == "encdec":
        x, caches = encdec_decode(params, cfg, x, caches)
    elif cfg.family == "hybrid":
        x, caches = hybrid_decode(params, cfg, x, caches)
    elif cfg.family == "ssm":
        x, caches = ssm_decode(params, cfg, x, caches)
    elif cfg.local_global_pattern:
        x, caches = patterned_decode(params, cfg, x, caches)
    else:
        x, caches = dense_decode(params, cfg, x, caches)
    x = norm(x, params.final_norm, cfg)
    return unembed(x[:, 0], params.head)[..., :cfg.vocab_size], caches


@torch.no_grad()
def prefill_with_cache(params: LM, cfg: ArchConfig, tokens: torch.Tensor,
                       s_max: int) -> Tuple[torch.Tensor, KVCache]:
    """Forward plus the KV cache, for plain dense / GQA stacks only.
    Returns (last-position logits (B, padded vocab), the cache)."""
    assert cfg.family in ("dense", "vlm", "moe")
    assert not cfg.local_global_pattern and cfg.mla is None
    b, s = tokens.shape
    x = embed(tokens, params.embed)
    positions = _positions(b, s, cfg, x.device)
    pos2d = positions[..., 0] if cfg.mrope else positions
    ks, vs = [], []
    for lp in params.layers:
        h = norm(x, lp.ln1, cfg)
        q, k, v = _qkv(h, lp.attn, cfg, positions, cfg.rope_theta)
        bias = _mask_bias(pos2d, pos2d, True, cfg.sliding_window)
        o = attend(q, k, v, bias)
        x = x + torch.matmul(o.reshape(b, s, -1), lp.attn.wo)
        y, _ = _ffn(norm(x, lp.ln2, cfg), lp, cfg)
        x = x + y
        pad = s_max - s
        ks.append(torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)))
        vs.append(torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)))
    x = norm(x, params.final_norm, cfg)
    logits = unembed(x[:, -1], params.head)
    caches = KVCache(k=torch.stack(ks), v=torch.stack(vs),
                     length=torch.full((cfg.num_layers,), s,
                                       dtype=torch.int32, device=x.device))
    return logits, caches
