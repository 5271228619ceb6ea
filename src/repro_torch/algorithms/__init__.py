"""Sampler backends behind one registry (``repro/algorithms``). Importing
a backend module registers it."""
from repro_torch.algorithms.base import (  # noqa: F401
    CellBackend,
    SamplerBackend,
    SamplerKnobs,
    chunked_token_map,
    kernel_dispatch,
    knobs_from,
)
from repro_torch.algorithms.registry import (  # noqa: F401
    describe,
    get,
    register,
    registered,
)

from repro_torch.algorithms import zen_dense  # noqa: F401,E402  zen
from repro_torch.algorithms import zen_pallas  # noqa: F401,E402
