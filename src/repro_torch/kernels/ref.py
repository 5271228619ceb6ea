"""Plain oracles of the serving kernels, mirroring ``repro/kernels/ref.py``:
the whole (T, K) score matrix at once, with no chunking, written apart from
the kernels' plain versions so that each can be held against the other."""
from __future__ import annotations

import torch

from repro_torch.kernels.zen_sampler import gumbel_noise


def zen_infer_sample_ref(nwk_rows, nkd_rows, z_old, seeds, alpha_k, n_k, *,
                         beta: float, w_beta: float) -> torch.Tensor:
    """Oracle of ``ops.zen_infer_sample``: doc-side-only exclusion, frozen
    word/topic totals, noise at (seed[t], 0, topic)."""
    t, k = nwk_rows.shape
    cols = torch.arange(k, device=nwk_rows.device)[None, :]
    self_hit = (cols == z_old[:, None]).to(torch.float32)
    nw = nwk_rows.to(torch.float32)
    nd = nkd_rows.to(torch.float32) - self_hit
    a = alpha_k.to(torch.float32)[None, :]
    p = (nd + a) * (nw + beta) / (n_k.to(torch.float32)[None, :] + w_beta)
    g = gumbel_noise(seeds[:, None], 0, cols)
    score = torch.log(torch.clamp_min(p, 1e-30)) + g
    return torch.argmax(score, dim=-1).to(torch.int32)


def zen_fused_infer_sample_ref(n_wk, n_kd, word, slot, z_old, seeds,
                               alpha_k, n_k, *, beta: float,
                               w_beta: float) -> torch.Tensor:
    """Oracle of ``ops.zen_fused_infer_sample``: gather, then the
    gathered-row oracle."""
    return zen_infer_sample_ref(
        n_wk[word.long()], n_kd[slot.long()], z_old, seeds, alpha_k, n_k,
        beta=beta, w_beta=w_beta,
    )
