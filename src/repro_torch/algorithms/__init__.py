"""Sampler backends behind one registry (``repro/algorithms``). Importing
a backend module registers it."""
from repro_torch.algorithms.base import (  # noqa: F401
    CellBackend,
    SamplerBackend,
    SamplerKnobs,
    auto_pad,
    chunked_token_map,
    fill_cell_row_pads,
    kernel_dispatch,
    knobs_from,
    resolve_row_pads,
)
from repro_torch.algorithms.registry import (  # noqa: F401
    describe,
    get,
    register,
    registered,
)

# importing a backend module registers it (order = registered() order,
# the reference's)
from repro_torch.algorithms import zen_dense  # noqa: F401,E402  zen, std
from repro_torch.algorithms import zen_sparse  # noqa: F401,E402
from repro_torch.algorithms import zen_hybrid  # noqa: F401,E402
from repro_torch.algorithms import sparselda  # noqa: F401,E402
from repro_torch.algorithms import lightlda  # noqa: F401,E402
from repro_torch.algorithms import zen_cdf  # noqa: F401,E402
from repro_torch.algorithms import zen_pallas  # noqa: F401,E402
