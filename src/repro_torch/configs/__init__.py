"""Config registry (``repro/configs``): ``get_config(arch_id)`` /
``list_archs()``.

One module per LM architecture (the published figures) + the paper's own
LDA configs (``zenlda.NYTIMES``, ``zenlda.WEBCHUNK``), field for field the
JAX package's, in the same order. ``get_config('<id>-smoke')`` returns the
reduced smoke variant. Pure dataclasses: nothing here imports torch or
JAX. ``repro_torch.models`` builds and serves the LM configs; where
their docstrings speak of chips, mesh axes and per-chip budgets they
describe the JAX package's TPU dry-run plan, not anything measured here.
"""
from __future__ import annotations

from typing import Dict, List, Union

from repro_torch.configs.base import ArchConfig, LDAArchConfig, ShapeConfig

# input-shape cells (LM shapes are seq_len x global_batch)
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def _registry() -> Dict[str, Union[ArchConfig, LDAArchConfig]]:
    from repro_torch.configs import (
        arctic_480b,
        falcon_mamba_7b,
        gemma3_4b,
        grok1_314b,
        minicpm3_4b,
        qwen1_5_4b,
        qwen2_vl_2b,
        qwen3_8b,
        whisper_medium,
        zamba2_1_2b,
        zenlda,
    )

    cfgs = [
        gemma3_4b.CONFIG,
        qwen1_5_4b.CONFIG,
        qwen3_8b.CONFIG,
        minicpm3_4b.CONFIG,
        zamba2_1_2b.CONFIG,
        whisper_medium.CONFIG,
        grok1_314b.CONFIG,
        arctic_480b.CONFIG,
        falcon_mamba_7b.CONFIG,
        qwen2_vl_2b.CONFIG,
        zenlda.NYTIMES,
        zenlda.WEBCHUNK,
    ]
    return {c.name: c for c in cfgs}


def get_config(name: str) -> Union[ArchConfig, LDAArchConfig]:
    reg = _registry()
    if name.endswith("-smoke"):
        base = reg[name[: -len("-smoke")]]
        assert isinstance(base, ArchConfig)
        return base.reduced()
    return reg[name]


def list_archs(lm_only: bool = False) -> List[str]:
    return [
        k for k, v in _registry().items()
        if not (lm_only and isinstance(v, LDAArchConfig))
    ]


def shapes_for(cfg: Union[ArchConfig, LDAArchConfig]) -> List[str]:
    """The shape cells this arch runs (the skip rules: ``long_500k``
    only for sub-quadratic archs)."""
    if isinstance(cfg, LDAArchConfig):
        return ["train_lda"]
    return [s for s in SHAPES if s not in cfg.skip_shapes]
