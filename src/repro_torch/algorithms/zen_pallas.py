"""``zen_pallas`` (+ ``zen_dense_kernel`` alias): the fused three-term
Gumbel-max sampler, for training and serving. The registry names are the
reference's, so one config names one backend in both packages; here the
samplers are the hand-written CUDA kernels of ``kernels/csrc``
(``zen_train.cu`` for training, ``zen_infer.cu`` for serving)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.algorithms.base import (
    CellBackend,
    SamplerKnobs,
    chunked_token_map,
    kernel_dispatch,
)
from repro_torch.algorithms.registry import register
from repro_torch.core.keys import token_seeds
from repro_torch.core.sampler import check_token_chunk
from repro_torch.kernels.ops import (
    zen_fused_infer_sample,
    zen_fused_sample,
    zen_infer_sample,
    zen_sample,
)

# tokens of one gathered-kernel launch: bounds its two (chunk, K) int32
# row matrices to 2^30 elements each (4 GiB)
GATHER_CHUNK_ELEMS = 1 << 30


def _index32(token_index):
    """A token index as the kernels read it: contiguous int32."""
    if token_index is None:
        return None
    return token_index.to(torch.int32).contiguous()


class FrozenPallasModel(NamedTuple):
    """``prepare_infer`` precompute: the per-topic vectors the kernels
    read, derived once per engine."""

    alpha_k: torch.Tensor  # (K,) f32
    n_k_f: torch.Tensor  # (K,) f32 frozen topic totals


@register("zen_pallas", "zen_dense_kernel")
class ZenPallas(CellBackend):
    """Fused three-term Gumbel-max sampler (CUDA kernels on the card)."""

    native_infer = True

    def cell_sweep(self, seed, word, doc, z_old, mask, n_wk, n_kd, n_k,
                   hyper, num_words_pad, knobs: SamplerKnobs,
                   token_index=None):
        """One training sweep through the kernels: exact ¬dw exclusion on
        all three counts, noise at (seed, global token index, topic); the
        global index is ``token_index[t]`` where given (a mesh cell's
        corpus indices, int32 on the tokens' device), else t.

        With the kernel policy on (``auto`` on CUDA) the fused kernel
        reads ``n_wk[word]``/``n_kd[doc]`` in place: one launch per sweep,
        whatever ``token_chunk`` is (the rows are never materialised). With
        it off, the gathered kernel runs on rows gathered here, one launch
        per chunk (``token_chunk``, else ``GATHER_CHUNK_ELEMS`` of rows).
        The two are bit-identical; on the CPU both run plain torch."""
        alpha_k = hyper.alpha_k(n_k).contiguous()
        n_k_f = n_k.to(torch.float32).contiguous()
        w_beta = num_words_pad * hyper.beta
        n_wk_i = n_wk.to(torch.int32).contiguous()
        n_kd_i = n_kd.to(torch.int32).contiguous()
        kw = dict(beta=hyper.beta, w_beta=w_beta, bt=knobs.bt, bk=knobs.bk)
        if kernel_dispatch(knobs.kernels, word.device):
            check_token_chunk(word.shape[0], knobs.token_chunk)
            return zen_fused_sample(
                n_wk_i, n_kd_i, word.contiguous(), doc.contiguous(),
                z_old.contiguous(), alpha_k, n_k_f, seed,
                token_index=_index32(token_index), **kw)

        def chunk(start, w, d, z):
            rows = dict(row_offset=start) if token_index is None \
                else dict(token_index=_index32(start))
            return zen_sample(n_wk_i[w.long()], n_kd_i[d.long()],
                              z.contiguous(), alpha_k, n_k_f, seed,
                              **rows, **kw)

        return chunked_token_map(chunk, (word, doc, z_old),
                                 knobs.token_chunk, n_k.shape[0],
                                 GATHER_CHUNK_ELEMS, token_index)

    def prepare_infer(self, n_wk, n_k, hyper, knobs: SamplerKnobs,
                      num_words_total=None):
        return FrozenPallasModel(
            alpha_k=hyper.alpha_k(n_k).contiguous(),
            n_k_f=n_k.to(torch.float32).contiguous(),
        )

    def infer_sweep(self, keys, words, mask, z_old, n_kd, n_wk, n_k, hyper,
                    knobs: SamplerKnobs, aux=None, num_words_total=None):
        """Frozen-model serving through the kernels: doc-side exclusion
        only, per-token seeds ``golden_seed(slot key words, position)``.

        With the kernel policy on (``auto`` on CUDA) the fused kernel reads
        ``n_wk[word]``/``n_kd[slot]`` in place; with it off, the gathered
        kernel runs on rows gathered here. The two are bit-identical, and
        both are kernels on the card; on the CPU both run plain torch."""
        if aux is None:
            aux = self.prepare_infer(n_wk, n_k, hyper, knobs)
        b, l = words.shape
        dev = words.device
        slot = torch.arange(b, dtype=torch.int32,
                            device=dev).repeat_interleave(l)
        w = words.reshape(-1).to(torch.int32).contiguous()
        z = z_old.reshape(-1).to(torch.int32).contiguous()
        seeds = token_seeds(keys.to(dev), l).reshape(-1)
        w_total = n_wk.shape[0] if num_words_total is None \
            else num_words_total
        n_wk_i = n_wk.to(torch.int32).contiguous()
        n_kd_i = n_kd.to(torch.int32).contiguous()
        if kernel_dispatch(knobs.kernels, dev):
            out = zen_fused_infer_sample(
                n_wk_i, n_kd_i, w, slot, z, seeds, aux.alpha_k, aux.n_k_f,
                beta=hyper.beta, w_beta=w_total * hyper.beta,
                bt=knobs.bt, bk=knobs.bk,
            )
        else:
            out = zen_infer_sample(
                n_wk_i[w.long()], n_kd_i[slot.long()], z, seeds,
                aux.alpha_k, aux.n_k_f,
                beta=hyper.beta, w_beta=w_total * hyper.beta,
                bt=knobs.bt, bk=knobs.bk,
            )
        return out.reshape(b, l)
