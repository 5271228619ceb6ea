"""Sharding rules (``repro/sharding``): the LM's parameters, batches and
decode caches as specs and DTensor placements, and the row layout of the
serving tables."""
from repro_torch.sharding.partition import (  # noqa: F401
    batch_sharding,
    batch_spec,
    cache_sharding,
    data_axes_of,
    opt_shardings,
    param_shardings,
    param_specs,
    shard_rows_balanced,
)
