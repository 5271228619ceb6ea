"""``sparselda``: SparseLDA (Yao et al.) on the shared substrate (paper
§7.2): the s/r/q three-bucket decomposition, exact self-exclusion; the
work is in ``core.baselines``.

The r and q inversions go through kernel 6 whatever the ``kernels``
policy, as for ``zen_sparse`` (the reference's dispatch is bit-identical
to its inline form).
"""
from __future__ import annotations

from repro_torch.algorithms.base import (  # noqa: F401
    CellBackend,
    SamplerKnobs,
    kernel_dispatch,  # the reference's module surface
)
from repro_torch.algorithms.registry import register
from repro_torch.core.baselines import sparselda_cell


@register("sparselda")
class SparseLDA(CellBackend):
    """s/r/q bucket sampler; work/token tracks O(K_d + K_w)."""

    needs_row_pads = True

    def cell_sweep(self, seed, word, doc, z_old, mask, n_wk, n_kd, n_k,
                   hyper, num_words_pad, knobs: SamplerKnobs,
                   token_index=None):
        knobs = self.resolve_cell_knobs(knobs, hyper)
        return sparselda_cell(
            seed, word, doc, z_old, n_wk, n_kd, n_k, hyper, num_words_pad,
            knobs.max_kw, knobs.max_kd, knobs.token_chunk, token_index,
        )
