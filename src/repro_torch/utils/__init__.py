"""Small shared utilities (``repro/utils``). ``compat`` holds JAX version
shims only and has no counterpart here."""
from repro_torch.utils.prng import fold_in_str, split_like
from repro_torch.utils.treeutil import tree_bytes, tree_param_count

__all__ = ["fold_in_str", "split_like", "tree_bytes", "tree_param_count"]
