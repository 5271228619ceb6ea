"""Row sharding of the serving tables (``repro/sharding``): the LDA half
only; the LM parameter shardings belong to the LM zoo."""
from repro_torch.sharding.partition import shard_rows_balanced  # noqa: F401
