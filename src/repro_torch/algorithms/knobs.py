"""``SamplerKnobs`` and the one knob derivation ``knobs_from``.

Re-exported by ``algorithms.base`` (the reference keeps them there). This
module imports no ``repro_torch.core``: ``core.trainer`` imports it at the
top while ``repro_torch.core`` initialises, and ``algorithms.base`` imports
``repro_torch.core``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# SamplerKnobs.kernels policy: "auto" = kernels when the tensors lie on
# CUDA; "on"/"off" pick the fused or the gathered kernel there
VALID_KERNEL_MODES = ("auto", "on", "off")

# the reference's tile floors, kept so that one config validates alike in
# both packages (bt/bk/bs reach no CUDA kernel: kernels.ops)
_MIN_BT = 8
_LANE = 128


@dataclasses.dataclass(frozen=True)
class SamplerKnobs:
    """Algorithm knobs shared by every backend; same fields and the same
    validation as the reference's."""

    sampling_method: str = "cdf"  # dense paths: cdf | gumbel
    max_kw: int = 0
    max_kd: int = 0
    num_mh: int = 8
    token_chunk: int = 0
    bt: int = 256
    bk: int = 512
    bs: int = 128
    kernels: str = "auto"  # auto | on | off

    def __post_init__(self):
        if self.bt < _MIN_BT:
            raise ValueError(
                f"SamplerKnobs.bt={self.bt}: token tiles need at least "
                f"{_MIN_BT} rows"
            )
        for name, v in (("bk", self.bk), ("bs", self.bs)):
            if v < _LANE or v % _LANE:
                raise ValueError(
                    f"SamplerKnobs.{name}={v}: topic/lane tiles must be "
                    f"positive multiples of {_LANE}"
                )
        if self.kernels not in VALID_KERNEL_MODES:
            raise ValueError(
                f"SamplerKnobs.kernels={self.kernels!r}: expected one of "
                f"{VALID_KERNEL_MODES}"
            )

    def chunk_or_none(self) -> Optional[int]:
        return self.token_chunk or None


_KNOB_FIELDS = tuple(f.name for f in dataclasses.fields(SamplerKnobs))


def knobs_from(cfg) -> SamplerKnobs:
    """THE SamplerKnobs derivation: every training config builds its knobs
    here, from the fields it shares with :class:`SamplerKnobs`."""
    return SamplerKnobs(**{f: getattr(cfg, f) for f in _KNOB_FIELDS})
