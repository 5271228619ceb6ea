"""LM train step (``repro/train/train_step.py``): loss, gradients and the
optimizer, microbatched.

``make_train_step`` returns ``(state, batch) -> (state, metrics)``; the
state's parameters and optimizer state are updated in place (the
reference donates them). Gradients come from ``torch.autograd.grad``, so
a bf16 parameter's gradient is bf16, as ``jax.grad`` gives it, and no
``.grad`` is left on the model. With microbatches each one's gradients
are summed in float32 buffers and divided, as the reference's scan does,
so the optimizer then sees float32 gradients. Metrics stay tensors on
the parameters' device: reading one syncs, nothing here does.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import LM, init_params, loss_fn
from repro_torch.sharding.dtensor import dtensor_scope, is_dtensor
from repro_torch.train.optimizer import OptConfig, make_optimizer


class TrainState(NamedTuple):
    params: LM
    opt_state: Any
    step: torch.Tensor  # () int32


def init_train_state(rng: Union[int, torch.Generator], cfg: ArchConfig,
                     opt_cfg: Optional[OptConfig] = None,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> TrainState:
    """A random, trainable ``LM`` (``init_params``: on the card unless
    ``device`` says otherwise) and its optimizer's zero state."""
    opt_cfg = opt_cfg or OptConfig()
    params = init_params(rng, cfg, device).requires_grad_(True)
    opt_init, _ = make_optimizer(cfg.optimizer, opt_cfg)
    return TrainState(params=params, opt_state=opt_init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=params.embed.device))


def compute_grads(params: LM, cfg: ArchConfig,
                  batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                             Dict[str, torch.Tensor]]:
    """(loss, metrics, {parameter name: gradient}); a parameter the loss
    does not reach gets zeros, as ``jax.grad`` gives it."""
    named = list(params.named_parameters())
    with torch.enable_grad(), dtensor_scope(params.embed):
        loss, metrics = loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        n: torch.zeros_like(p) if g is None else _placed_as(g, p)
        for (n, p), g in zip(named, grads)}


def _placed_as(g, p):
    """A DTensor parameter's gradient in the parameter's placements (a
    replicated parameter's gradient comes back partial over the axes that
    shard the batch); a plain gradient as it is."""
    if not is_dtensor(p) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def make_train_step(cfg: ArchConfig, opt_cfg: Optional[OptConfig] = None,
                    num_microbatches: int = 1):
    opt_cfg = opt_cfg or OptConfig()
    _, opt_update = make_optimizer(cfg.optimizer, opt_cfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        if num_microbatches == 1:
            loss, metrics, grads = compute_grads(params, cfg, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % num_microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{num_microbatches} microbatches")
            size = b // num_microbatches
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=params.embed.device)
            for i in range(num_microbatches):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                l_mb, _, g_mb = compute_grads(params, cfg, mb)
                for n, g in g_mb.items():
                    grads[n] += g.to(torch.float32)
                loss = loss + l_mb
                del g_mb
            for g in grads.values():
                g.div_(num_microbatches)
            loss = loss / num_microbatches
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}

        _, new_opt, opt_metrics = opt_update(params, grads, state.opt_state)
        del grads
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        # a DTensor metric (partial over the batch shards) as its value
        metrics = {k: v.full_tensor() if is_dtensor(v) else v
                   for k, v in metrics.items()}
        return (TrainState(params=params, opt_state=new_opt,
                           step=state.step + 1), metrics)

    return train_step
