"""The port's parameter tree against the reference's: the round trip
through ``params_from_reference`` / ``params_to_reference``, and the
leaf shapes and parameter counts of the ten full configs."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.launch.specs import params_abstract
from repro.models import model as R
from repro_torch.configs import get_config as port_config
from repro_torch.models import model as P
from repro_torch.models.convert import (
    _tree_path,
    params_from_reference,
    params_to_reference,
)
from torch_lm_common import ARCHS, smoke_cfg


@pytest.mark.parametrize("arch,dtype", [("qwen3-8b", "bfloat16"),
                                        ("gemma3-4b", "float32"),
                                        ("zamba2-1.2b", "bfloat16"),
                                        ("whisper-medium", "float32"),
                                        ("minicpm3-4b", "bfloat16")])
def test_params_round_trip_is_exact(arch, dtype):
    """reference tree -> LM -> tree: the same structure, dtypes and bits
    (bf16 leaves through their 16-bit patterns)."""
    cfg = smoke_cfg(arch, dtype=dtype)
    tree = jax.tree.map(np.asarray, R.init_params(jax.random.key(11), cfg))
    lm = params_from_reference(tree, cfg, device="cpu")
    back = params_to_reference(lm)
    assert jax.tree.structure(tree) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    if dtype == "bfloat16":
        assert lm.embed.dtype == torch.bfloat16
        assert lm.final_norm.scale.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_shapes_match_reference(arch):
    """The full config on the ``meta`` device (nothing allocated): every
    leaf's shape and dtype, and the count, equal ``params_abstract``'s."""
    cfg = port_config(arch)
    lm = P.init_params(0, cfg, device="meta")
    ref = params_abstract(get_config(arch))
    port = params_to_shapes(lm)
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(ref_leaves) == len(port)
    for path, leaf in ref_leaves:
        key = tuple(k.key for k in path)
        shape, dtype = port[key]
        assert shape == tuple(leaf.shape), key
        assert dtype == str(leaf.dtype), key
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(ref))
    assert lm.num_params() == n_ref
    if arch == "qwen3-8b":
        assert n_ref == 8_191_783_936


def params_to_shapes(lm):
    """{tree path: (stacked shape, dtype name)} of the port's leaves."""
    out = {}
    for name, p in lm.named_parameters():
        keys, index = _tree_path(name)
        shape, dtype = tuple(p.shape), str(p.dtype).replace("torch.", "")
        if index is None:
            out[tuple(keys)] = (shape, dtype)
        else:
            n = out.get(tuple(keys), ((0,), dtype))[0][0]
            out[tuple(keys)] = ((max(n, index + 1),) + shape, dtype)
    return out
