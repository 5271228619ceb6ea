"""``repro_torch.utils.prng`` against ``repro.utils.prng``, on the CPU.

The key values cannot equal threefry's; what can is equal: the integer
``fold_in_str`` folds in for a name (caught by spies on both packages'
``fold_in``), and ``split_like``'s tree structure and leaf order
(``jax.tree_util``'s, on a nested dict / list / tuple / NamedTuple tree).
"""
import collections

import jax
import pytest
import torch

import repro.utils.prng as jprng
import repro_torch.utils.prng as tprng
from repro_torch.core.keys import as_key, split
from repro_torch.utils import fold_in_str, split_like

NAMES = ["", "layer.0.attn", "embed", "ünïcode", "x" * 300]

Pair = collections.namedtuple("Pair", "left right")


@pytest.mark.parametrize("name", NAMES)
def test_fold_in_str_folds_the_reference_integer(name, monkeypatch):
    seen = {}
    real_j, real_t = jax.random.fold_in, tprng.fold_in

    def spy_j(key, data):
        seen["ref"] = int(data)
        return real_j(key, data)

    def spy_t(key, data):
        seen["port"] = int(data)
        return real_t(key, data)

    monkeypatch.setattr(jprng.jax.random, "fold_in", spy_j)
    monkeypatch.setattr(tprng, "fold_in", spy_t)
    jprng.fold_in_str(jax.random.key(0), name)
    fold_in_str(as_key(0), name)
    assert seen["port"] == seen["ref"] == tprng.name_hash(name)


def test_fold_in_str_is_deterministic_and_separates_names():
    key = as_key(7)
    keys = [fold_in_str(key, n) for n in NAMES]
    assert all(torch.equal(k, fold_in_str(key, n))
               for k, n in zip(keys, NAMES))
    flat = {tuple(k.tolist()) for k in keys}
    assert len(flat) == len(NAMES)
    assert not torch.equal(fold_in_str(as_key(8), "embed"),
                           fold_in_str(key, "embed"))


def _tree():
    return {"b": [1.0, (2.0, 3.0)], "a": {"y": 4.0, "x": None, "z": [5.0]},
            "c": Pair(6.0, [7.0, 8.0]), "d": ()}


def test_split_like_has_the_reference_structure_and_leaf_order():
    tree = _tree()
    port = split_like(as_key(3), tree)
    ref = jprng.split_like(jax.random.key(3), tree)
    assert jax.tree_util.tree_structure(port) == \
        jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(ref)
    assert isinstance(port["c"], Pair)
    leaves = jax.tree_util.tree_leaves(port)
    n = len(jax.tree_util.tree_leaves(tree))
    assert len(leaves) == n == 8
    # leaf i in jax's order holds the i-th key of one split
    want = split(as_key(3), n)
    for i, leaf in enumerate(leaves):
        assert torch.equal(leaf, want[i]), i
    # every key distinct, and none the parent key
    flat = {tuple(k.tolist()) for k in leaves}
    assert len(flat) == n and tuple(as_key(3).tolist()) not in flat


def test_split_like_on_a_leaf_and_on_an_empty_tree():
    one = split_like(as_key(1), torch.zeros(3))
    assert torch.equal(one, split(as_key(1), 1)[0])
    assert split_like(as_key(1), {"a": None, "b": []}) == {"a": None,
                                                           "b": []}
