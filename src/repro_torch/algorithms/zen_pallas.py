"""``zen_pallas`` (+ ``zen_dense_kernel`` alias): the frozen-model
Gumbel-max sampler as a serving backend. The registry names are the
reference's, so one config names one backend in both packages; here the
sampler is the hand-written CUDA kernel pair of ``kernels/csrc``."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.algorithms.base import (
    SamplerBackend,
    SamplerKnobs,
    kernel_dispatch,
)
from repro_torch.algorithms.registry import register
from repro_torch.core.keys import token_seeds
from repro_torch.kernels.ops import zen_fused_infer_sample, zen_infer_sample


class FrozenPallasModel(NamedTuple):
    """``prepare_infer`` precompute: the per-topic vectors the kernels
    read, derived once per engine."""

    alpha_k: torch.Tensor  # (K,) f32
    n_k_f: torch.Tensor  # (K,) f32 frozen topic totals


@register("zen_pallas", "zen_dense_kernel")
class ZenPallas(SamplerBackend):
    """Fused three-term Gumbel-max sampler (CUDA kernel on the card)."""

    native_infer = True

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
