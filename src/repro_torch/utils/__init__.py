"""Small shared utilities (``repro/utils``). ``prng`` and ``compat`` are
JAX helpers with no counterpart here yet."""
from repro_torch.utils.treeutil import tree_bytes, tree_param_count

__all__ = ["tree_bytes", "tree_param_count"]
