"""``lightlda``: LightLDA (Yuan et al.) cycle Metropolis-Hastings on the
shared substrate (paper §7.2); the work is in ``core.baselines``.

``prepare`` builds the corpus-level doc -> token index the single-box
``sweep`` uses for the O(1) doc proposal; ``cell_sweep`` builds the index
of the cell's own tokens (masked padding excluded) every sweep.

The ``kernels`` policy picks the word proposal's sparse branch, as in the
reference: on (``auto`` on the card) it is drawn by CDF inversion through
kernel 6; off, through per-word alias tables with no kernel. Both sample
the same density, so the MH chain is the same sampler.
"""
from __future__ import annotations

from repro_torch.algorithms.base import (
    CellBackend,
    SamplerKnobs,
    kernel_dispatch,
)
from repro_torch.algorithms.registry import register
from repro_torch.core.baselines import (
    build_cell_doc_index,
    build_doc_index,
    lightlda_cell,
    lightlda_sweep,
)


@register("lightlda")
class LightLDA(CellBackend):
    """Alternating word/doc proposals, ``num_mh`` MH steps per token."""

    needs_doc_index = True
    needs_row_pads = True

    def prepare(self, corpus, hyper, knobs: SamplerKnobs):
        return build_doc_index(corpus)

    def sweep(self, state, corpus, hyper, knobs: SamplerKnobs, aux=None):
        # single-box keeps the prepared corpus-level index (static across
        # iterations)
        if aux is None:
            raise ValueError("lightlda needs prepare()'s doc index")
        knobs = self.resolve_cell_knobs(knobs, hyper)
        return lightlda_sweep(
            state, corpus, hyper, aux, knobs.max_kw, num_mh=knobs.num_mh,
            use_kernel=kernel_dispatch(knobs.kernels, corpus.word.device),
            token_chunk=knobs.token_chunk,
        )

    def cell_sweep(self, seed, word, doc, z_old, mask, n_wk, n_kd, n_k,
                   hyper, num_words_pad, knobs: SamplerKnobs,
                   token_index=None):
        knobs = self.resolve_cell_knobs(knobs, hyper)
        doc_index = build_cell_doc_index(doc, mask, n_kd.shape[0])
        return lightlda_cell(
            seed, word, doc, z_old, mask, n_wk, n_kd, n_k, hyper,
            num_words_pad, doc_index, knobs.max_kw, num_mh=knobs.num_mh,
            use_kernel=kernel_dispatch(knobs.kernels, word.device),
            token_chunk=knobs.token_chunk, token_index=token_index,
        )
