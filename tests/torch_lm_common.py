"""Shared set-up of the LM port's tests: the reference's parameters at a
smoke config in float32, carried into the port with
``params_from_reference``, and the inputs both packages are given."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config, list_archs
from repro.models import model as R
from repro_torch.models.convert import params_from_reference

ARCHS = list_archs(lm_only=True)
TOL = dict(rtol=1e-4, atol=1e-4)


def smoke_cfg(arch, **changes):
    """The reference's smoke config in float32 (as its tests run it)."""
    return dataclasses.replace(get_config(arch + "-smoke"),
                               **{"dtype": "float32", **changes})


def both_params(cfg, seed=0):
    """(reference tree of jax arrays, the port's ``LM`` on the CPU)."""
    tree = R.init_params(jax.random.key(seed), cfg)
    lm = params_from_reference(jax.tree.map(np.asarray, tree), cfg,
                               device="cpu")
    return tree, lm


def batch(cfg, b=2, s=16, seed=0):
    """numpy inputs for ``forward``: tokens, and the family's extras."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        out["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32)[None, :, None], (b, s, 3)).copy()
    return out


def to_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def to_torch(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in d.items()}


def leaves(tree):
    """A cache's leaves in order, as numpy (None entries skipped, as
    ``jax.tree.leaves`` skips them)."""
    return [np.asarray(x) for x in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))]


def ref_decode(cfg):
    """The reference's decode step, jitted once per config."""
    return jax.jit(lambda p, t, c: R.decode_step(p, cfg, t, c))
