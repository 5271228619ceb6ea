"""``zen`` (+ ``zen_dense`` alias): the dense three-term backend. In this
slice it serves through the default dense frozen-phi sweep; its training
sweep comes with the training slice."""
from __future__ import annotations

from repro_torch.algorithms.base import SamplerBackend
from repro_torch.algorithms.registry import register


@register("zen", "zen_dense")
class ZenDense(SamplerBackend):
    """ZenLDA three-term decomposition over dense rows (paper Eq. 3)."""
