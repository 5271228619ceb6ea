"""``zen_hybrid``: ZenLDAHybrid (paper §3.1): per token, the decomposition
whose fresh term ranges over the sparser row.

Two-group dispatch over the registry's own ``zen_sparse`` (fresh term over
K_d) and ``sparselda`` (fresh term over K_w) backends, so it follows any
change to either. The switch prices each side by the row it actually
samples: the row nnz clamped to the constituent's padded width, from the
count blocks the constituents get.
"""
from __future__ import annotations

import torch

from repro_torch.algorithms.base import CellBackend, SamplerKnobs
from repro_torch.algorithms.registry import get, register


def hybrid_route_doc_side(n_wk: torch.Tensor, n_kd: torch.Tensor,
                          word: torch.Tensor, doc: torch.Tensor,
                          max_kw: int, max_kd: int) -> torch.Tensor:
    """True where the doc-side decomposition (``zen_sparse``) samples the
    narrower effective row: nnz clamped to the constituent's width."""
    kd_eff = torch.clamp_max(torch.sum(n_kd > 0, dim=-1), max_kd)
    kw_eff = torch.clamp_max(torch.sum(n_wk > 0, dim=-1), max_kw)
    return kd_eff[doc.long()] <= kw_eff[word.long()]


@register("zen_hybrid")
class ZenHybrid(CellBackend):
    """Route each token to the sparser of the two decompositions."""

    needs_row_pads = True

    def cell_sweep(self, seed, word, doc, z_old, mask, n_wk, n_kd, n_k,
                   hyper, num_words_pad, knobs: SamplerKnobs,
                   token_index=None):
        knobs = self.resolve_cell_knobs(knobs, hyper)
        use_zen = hybrid_route_doc_side(n_wk, n_kd, word, doc, knobs.max_kw,
                                        knobs.max_kd)
        z_zen = get("zen_sparse").cell_sweep(
            seed, word, doc, z_old, mask, n_wk, n_kd, n_k, hyper,
            num_words_pad, knobs, token_index=token_index)
        z_alt = get("sparselda").cell_sweep(
            seed, word, doc, z_old, mask, n_wk, n_kd, n_k, hyper,
            num_words_pad, knobs, token_index=token_index)
        return torch.where(use_zen, z_zen, z_alt)
