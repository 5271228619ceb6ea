"""Cached decode in the port against the reference: 8 ``decode_step``s
from ``init_cache`` for each of the ten ``-smoke`` configs in float32
(logits and every cache leaf, rtol/atol 1e-4), the sliding-window ring
past its wrap, and the clamped write past ``s_max``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as R
from repro_torch.models import model as P
from torch_lm_common import (
    ARCHS,
    TOL,
    both_params,
    leaves,
    ref_decode,
    smoke_cfg,
)


def _decode_both(cfg, steps, b, s_max, seed=0):
    tree, lm = both_params(cfg)
    s_enc = 16 if cfg.family == "encdec" else 0
    rc = R.init_cache(cfg, b, s_max, s_enc=s_enc)
    pc = P.init_cache(cfg, b, s_max, s_enc=s_enc, device="cpu")
    assert [x.shape for x in leaves(rc)] == [x.shape for x in leaves(pc)]
    step = ref_decode(cfg)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (steps, b)).astype(np.int32)
    for t in toks:
        rl, rc = step(tree, jnp.asarray(t), rc)
        with torch.no_grad():
            pl, pc = P.decode_step(lm, cfg, torch.from_numpy(t), pc)
        assert pl.shape == (b, cfg.vocab_size)
        np.testing.assert_allclose(np.asarray(rl), pl.numpy(), **TOL)
    return rc, pc


def _same_caches(rc, pc):
    ref, port = leaves(rc), leaves(pc)
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        assert r.dtype == p.dtype and r.shape == p.shape
        np.testing.assert_allclose(r, p, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    rc, pc = _decode_both(smoke_cfg(arch), 8, 2, 32)
    _same_caches(rc, pc)


def test_sliding_window_ring_wraps_like_the_reference():
    """gemma3's local layers keep a ring of ``window`` = 16 slots: 20
    steps overwrite slots 0-3; the global layers keep all 32."""
    cfg = smoke_cfg("gemma3-4b")
    rc, pc = _decode_both(cfg, 20, 2, 32, seed=1)
    assert pc["local"].k.shape[2] == cfg.sliding_window == 16
    assert pc["global"].k.shape[2] == 32
    _same_caches(rc, pc)
    assert int(pc["local"].length[0]) == 20


@pytest.mark.parametrize("arch", ["qwen3-8b", "minicpm3-4b"])
def test_decode_past_s_max_clamps_like_the_reference(arch):
    """``dynamic_update_slice`` clamps a start past S_max - 1: steps 4 and
    5 of an S_max = 4 cache both write the last slot (GQA and MLA), and
    the port writes where the reference writes."""
    cfg = smoke_cfg(arch, num_layers=2)
    rc, pc = _decode_both(cfg, 6, 2, 4, seed=2)
    _same_caches(rc, pc)
    assert int(pc.length[0]) == 6
    # the last slot holds step 5's token, not step 3's: replaying only
    # steps 0-3 leaves a different last slot
    _, pc4 = _decode_both(cfg, 4, 2, 4, seed=2)
    assert not torch.equal(pc.k[:, :, 3], pc4.k[:, :, 3])
    assert torch.equal(pc.k[:, :, :3], pc4.k[:, :, :3])
