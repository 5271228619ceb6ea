"""Sampler backends behind one registry (``repro/algorithms``), serving
half. Importing a backend module registers it."""
from repro_torch.algorithms.base import (  # noqa: F401
    SamplerBackend,
    SamplerKnobs,
    kernel_dispatch,
)
from repro_torch.algorithms.registry import (  # noqa: F401
    get,
    register,
    registered,
)

from repro_torch.algorithms import zen_dense  # noqa: F401,E402  zen
from repro_torch.algorithms import zen_pallas  # noqa: F401,E402
