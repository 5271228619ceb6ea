"""Public kernel wrappers: a CPU tensor runs the plain version, a CUDA
tensor launches the hand-written kernel, any other device raises.

Arguments mirror ``repro/kernels/ops.py``. ``bt``/``bk`` are accepted so
that callers and configs carry over, but they change no draw: the CUDA
kernels walk the real K with one warp per token and need no padding.

Each wrapper counts its kernel launches in a plain int
(:func:`launch_counts`), so a run can show that its main path went
through the kernels; plain-version calls are not counted.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.fused_gather import (
    zen_fused_infer_sample_cuda,
    zen_fused_infer_sample_plain,
)
from repro_torch.kernels.zen_sampler import (
    zen_infer_sample_cuda,
    zen_infer_sample_plain,
)

_LAUNCHES: Dict[str, int] = {
    "zen_infer_sample": 0,
    "zen_fused_infer_sample": 0,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _route(t) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel or plain version for device {t.device}")


def zen_infer_sample(nwk_rows, nkd_rows, z_old, seeds, alpha_k, n_k, *,
                     beta: float, w_beta: float, bt: int = 256,
                     bk: int = 512):
    """Frozen-model serving draw on gathered (T, K) rows: doc-side
    exclusion only, per-token counter-based seeds. Returns (T,) int32."""
    if _route(nwk_rows) == "cpu":
        return zen_infer_sample_plain(
            nwk_rows, nkd_rows, z_old, seeds, alpha_k, n_k,
            beta=beta, w_beta=w_beta,
        )
    out = zen_infer_sample_cuda(
        nwk_rows, nkd_rows, z_old, seeds, alpha_k, n_k,
        beta=beta, w_beta=w_beta,
    )
    _LAUNCHES["zen_infer_sample"] += 1
    return out


def zen_fused_infer_sample(n_wk, n_kd, word, slot, z_old, seeds, alpha_k,
                           n_k, *, beta: float, w_beta: float,
                           bt: int = 256, bk: int = 512):
    """``zen_infer_sample(n_wk[word], n_kd[slot], ...)`` without the
    gathered rows; bit-identical to it. Returns (T,) int32."""
    if _route(n_wk) == "cpu":
        return zen_fused_infer_sample_plain(
            n_wk, n_kd, word, slot, z_old, seeds, alpha_k, n_k,
            beta=beta, w_beta=w_beta,
        )
    out = zen_fused_infer_sample_cuda(
        n_wk, n_kd, word, slot, z_old, seeds, alpha_k, n_k,
        beta=beta, w_beta=w_beta,
    )
    _LAUNCHES["zen_fused_infer_sample"] += 1
    return out
