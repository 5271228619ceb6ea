"""Abstract inputs and their shardings for every dry-run cell
(``repro/launch/specs.py``).

Nothing is allocated: an input is a ``meta`` tensor of the cell's shape
and dtype (an ``LM`` built on ``meta`` for the parameters), and its
sharding a ``sharding.partition.NamedSharding`` (a spec on the mesh; on a
``DeviceMesh`` it gives DTensor placements). Each (arch x shape) cell
resolves to:

  step_kind 'train'    -> train_step(state, batch)
  step_kind 'prefill'  -> forward(params, batch)        (logits)
  step_kind 'decode'   -> decode_step(params, token, caches)
  step_kind 'lda'      -> dist_step(state, data)        (one mesh iteration)
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config  # noqa: F401
from repro_torch.configs.base import ArchConfig, LDAArchConfig, ShapeConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import init_cache  # noqa: F401
from repro_torch.train.optimizer import OptConfig  # noqa: F401
from repro_torch.train.train_step import init_train_state  # noqa: F401
from repro_torch.sharding.partition import (
    NamedSharding,
    batch_sharding,
    cache_sharding,
    data_axes_of,
    mesh_sizes,
    opt_shardings,
    param_shardings,
)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Abstract batch for a full-sequence (train/prefill) cell."""
    b, s = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg)
    batch: Dict[str, Any] = {}
    if cfg.family == "encdec":
        # stub audio frontend: precomputed frame embeddings
        batch["enc_embeds"] = _meta((b, s, cfg.d_model), dt)
        batch["tokens"] = _meta((b, s), torch.int32)
    elif cfg.family == "vlm":
        # stub vision frontend: patch embeddings + 3D M-RoPE position ids
        batch["embeds"] = _meta((b, s, cfg.d_model), dt)
        batch["positions"] = _meta((b, s, 3), torch.int32)
    else:
        batch["tokens"] = _meta((b, s), torch.int32)
    if shape.kind == "train":
        batch["labels"] = _meta((b, s), torch.int32)
    return batch


def params_abstract(cfg: ArchConfig):
    """The ``LM`` on ``meta``: every parameter's shape and dtype."""
    from repro_torch.models.model import init_params

    return init_params(0, cfg, device="meta")


def state_abstract(cfg: ArchConfig):
    """A ``TrainState`` on ``meta`` (trainable parameters, the optimizer's
    zero state)."""
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state

    return init_train_state(0, cfg, OptConfig(), device="meta")


def lm_cell_specs(cfg: ArchConfig, shape: ShapeConfig, mesh: Any
                  ) -> Tuple[str, Dict[str, Any], Dict[str, Any]]:
    """(step_kind, {input: abstract value}, {input: shardings}); the
    shardings mirror each input's structure, parameters keyed by name."""
    from repro_torch.models.model import init_cache
    from repro_torch.train.train_step import TrainState

    if shape.kind == "train":
        state = state_abstract(cfg)
        batch = batch_specs(cfg, shape)
        # params + opt state share the param rules; step scalar replicated
        st_sh = TrainState(
            params=param_shardings(state.params, cfg, mesh),
            opt_state=opt_shardings(state.opt_state, state.params, cfg,
                                    mesh),
            step=NamedSharding(mesh, ()))
        return ("train", {"state": state, "batch": batch},
                {"state": st_sh, "batch": batch_sharding(batch, mesh)})
    if shape.kind == "prefill":
        params = params_abstract(cfg)
        batch = batch_specs(cfg, shape)
        return ("prefill", {"params": params, "batch": batch},
                {"params": param_shardings(params, cfg, mesh),
                 "batch": batch_sharding(batch, mesh)})
    # decode
    params = params_abstract(cfg)
    b = shape.global_batch
    s_enc = shape.seq_len if cfg.family == "encdec" else 0
    caches = init_cache(cfg, b, shape.seq_len, s_enc=s_enc, device="meta")
    token = _meta((b,), torch.int32)
    dp = math.prod(mesh_sizes(mesh)[a] for a in data_axes_of(mesh))
    tok_sh = NamedSharding(mesh, (data_axes_of(mesh),) if b % dp == 0
                           else ())
    return ("decode", {"params": params, "token": token, "caches": caches},
            {"params": param_shardings(params, cfg, mesh), "token": tok_sh,
             "caches": cache_sharding(caches, mesh)})


# ---------------------------------------------------------------------------
# LDA cells
# ---------------------------------------------------------------------------

def lda_dims(cfg: LDAArchConfig, mesh: Any) -> Dict[str, int]:
    """One cell's padded dims (each rounded up to a multiple of 8)."""
    sizes = mesh_sizes(mesh)
    dp = math.prod(sizes[a] for a in data_axes_of(mesh))
    mp = sizes["model"]
    cells = dp * mp
    return {
        "e_cell": int(math.ceil(cfg.tokens_per_step / cells / 8) * 8),
        "words_per_shard": int(math.ceil(cfg.num_words / mp / 8) * 8),
        "docs_per_shard": int(math.ceil(cfg.docs_per_step / dp / 8) * 8),
    }


def lda_cell_specs(cfg: LDAArchConfig, mesh: Any,
                   dims: Optional[Dict[str, int]] = None
                   ) -> Tuple[str, Dict[str, Any], Dict[str, Any],
                              Dict[str, int]]:
    """One rank's abstract ``DistLDAState`` / ``DistLDAData`` for one
    iteration, the shardings of the global arrays they are blocks of (the
    reference's ``state_shardings``), and the padded dims (``dims``, or
    :func:`lda_dims`'). The run key stays two real words on the host
    (``core.keys.key_seed`` reads it)."""
    from repro_torch.core.distributed import DistLDAData, DistLDAState

    dims = dims or lda_dims(cfg, mesh)
    e, k = dims["e_cell"], cfg.num_topics
    kd = getattr(torch, cfg.kd_dtype)
    state = DistLDAState(
        topic=_meta((e,), torch.int32), prev_topic=_meta((e,), torch.int32),
        n_wk=_meta((dims["words_per_shard"], k), torch.int32),
        n_kd=_meta((dims["docs_per_shard"], k), kd),
        n_k=_meta((k,), torch.int32),
        stale_iters=_meta((e,), torch.int32),
        same_count=_meta((e,), torch.int32),
        iteration=0, rng=torch.zeros((2,), dtype=torch.int64))
    data = DistLDAData(word=_meta((e,), torch.int32),
                       doc=_meta((e,), torch.int32),
                       mask=_meta((e,), torch.bool),
                       token=_meta((e,), torch.int32), num_real=e)
    data_axes = data_axes_of(mesh)
    tok = NamedSharding(mesh, (data_axes + ("model",),))
    rep = NamedSharding(mesh, ())
    st_sh = DistLDAState(
        topic=tok, prev_topic=tok,
        n_wk=NamedSharding(mesh, ("model", None)),
        n_kd=NamedSharding(mesh, (data_axes, None)),
        n_k=rep, stale_iters=tok, same_count=tok, iteration=rep, rng=rep)
    dt_sh = DistLDAData(word=tok, doc=tok, mask=tok, token=tok,
                        num_real=rep)
    return "lda", {"state": state, "data": data}, {
        "state": st_sh, "data": dt_sh}, dims
