"""``zen_sparse``: the faithful padded-sparse ZenLDA sampler (paper Alg. 2)
behind the backend contract; the work is in ``core.zen_sparse``.

Every term-3 inversion goes through kernel 6 (``kernels.ops.sparse_row_
sample``) whatever the ``kernels`` policy: the reference states that its
kernel dispatch is bit-identical to the inline form, so the policy picks
nothing here. On the card that is the CUDA kernel, on the CPU its plain
version.
"""
from __future__ import annotations

from repro_torch.algorithms.base import CellBackend, SamplerKnobs
from repro_torch.algorithms.registry import register
from repro_torch.core.zen_sparse import zen_sparse_cell


@register("zen_sparse")
class ZenSparse(CellBackend):
    """Alias tables + padded-sparse rows; work/token tracks O(K_d)."""

    needs_row_pads = True

    def cell_sweep(self, seed, word, doc, z_old, mask, n_wk, n_kd, n_k,
                   hyper, num_words_pad, knobs: SamplerKnobs,
                   token_index=None):
        knobs = self.resolve_cell_knobs(knobs, hyper)
        return zen_sparse_cell(
            seed, word, doc, z_old, n_wk, n_kd, n_k, hyper, num_words_pad,
            knobs.max_kw, knobs.max_kd, knobs.token_chunk, token_index,
        )
