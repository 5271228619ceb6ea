"""Device choice for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fallback."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for (or implied)
    and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch versions on the CPU"
        )
    return dev


def as_device_tensor(x, device: Optional[Union[str, torch.device]] = None
                     ) -> torch.Tensor:
    """``x`` as a tensor. A tensor stays on its own device unless
    ``device`` is given; host data (numpy, lists) goes to
    ``resolve_device(device)``: the card unless the caller asks for the
    CPU."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))
