"""Kernel 6, the padded-sparse row sampler, against the JAX package.

The port's ``ops.sparse_row_sample`` (its plain version on the CPU) and
its oracle ``ref.sparse_row_sample_ref`` add the prefix sums in the CUDA
kernel's order (32-lane shuffle-scan strips plus a carry), so the two are
bit-equal. The reference's ``ops.sparse_row_sample`` (its Pallas kernel in
interpret mode) and ``ref.sparse_row_sample_ref`` use ``jnp.cumsum``, whose
float32 order differs: a topic may differ only where the target lies
within 1e-5 of the row's mass from a prefix sum between the two landing
lanes (a near-tie). Such mismatches are counted, and the grid puts
targets exactly on the reference's prefix sums so that near-ties occur.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref, sparse_row

NEAR_TIE = 1e-5  # of the row's mass
J_GRID = (1, 5, 31, 32, 33, 128, 352, 1000)
SENTINEL = 1000  # K: the topic id of padded lanes


def _rows(seed, t, j):
    """(T, J) rows in the callers' layout: a sorted prefix of live topics
    with positive weights, then weight-0 lanes with the sentinel id; some
    rows hold no mass. Targets: uniform over the mass, 0, the mass, above
    it, and exactly on the reference's prefix sums."""
    rng = np.random.default_rng(seed)
    live = rng.integers(0, j + 1, t)
    live[:4] = 0  # zero-mass rows
    lanes = np.arange(j)[None, :]
    vals = (rng.random((t, j)) * rng.choice([1e-3, 1.0, 50.0], (t, 1)))
    vals = np.where(lanes < live[:, None], vals, 0.0).astype(np.float32)
    topics = np.sort(rng.choice(SENTINEL, (t, j)), axis=1).astype(np.int32)
    topics = np.where(lanes < live[:, None], topics, SENTINEL).astype(
        np.int32)
    mass = vals.astype(np.float64).sum(1)
    tgt = rng.random(t) * mass
    cdf = np.asarray(jnp.cumsum(jnp.asarray(vals), axis=1))
    on = rng.integers(0, j, t)
    tgt[::5] = cdf[np.arange(t), on][::5]  # exactly on a prefix sum
    tgt[1::7] = 0.0
    tgt[2::7] = mass[2::7]
    tgt[3::7] = mass[3::7] * 1.5 + 1.0
    return vals, topics, tgt.astype(np.float32)


def _port(fn, vals, topics, tgt):
    return fn(torch.from_numpy(vals), torch.from_numpy(topics),
              torch.from_numpy(tgt)).numpy()


def _near_tie_mismatches(vals, tgt, got, want, topics):
    """Rows where ``got`` != ``want``, after checking each is a near-tie:
    an exact (float64) prefix sum between the two landing lanes lies
    within NEAR_TIE of the row's mass from the target."""
    bad = np.flatnonzero(got != want)
    exact = np.cumsum(vals.astype(np.float64), axis=1)
    for t in bad:
        j = vals.shape[1]
        lanes = [min(int((exact[t] < tgt[t]).sum()), j - 1)]
        hits = np.flatnonzero(topics[t] == got[t]).tolist() \
            + np.flatnonzero(topics[t] == want[t]).tolist()
        lo, hi = min(hits + lanes), max(hits + lanes)
        gap = np.abs(exact[t, lo:hi + 1] - tgt[t]).min()
        assert gap <= NEAR_TIE * max(exact[t, -1], 1e-30), \
            (t, got[t], want[t], gap, exact[t, -1])
    return bad


@pytest.mark.parametrize("j", J_GRID)
def test_plain_version_and_oracle_bit_equal(j):
    vals, topics, tgt = _rows(j, 300, j)
    got = _port(ops.sparse_row_sample, vals, topics, tgt)
    want = _port(ref.sparse_row_sample_ref, vals, topics, tgt)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    # zero-mass rows with a positive target land on the last lane
    live = vals.sum(1) > 0
    pos_tgt = ~live & (tgt > 0)
    np.testing.assert_array_equal(got[pos_tgt], topics[pos_tgt, -1])


@pytest.mark.parametrize("j", J_GRID)
def test_matches_reference_kernel_and_oracle_up_to_near_ties(j):
    vals, topics, tgt = _rows(1000 + j, 300, j)
    got = _port(ops.sparse_row_sample, vals, topics, tgt)
    args = (jnp.asarray(vals), jnp.asarray(topics), jnp.asarray(tgt))
    j_kernel = np.asarray(jops.sparse_row_sample(*args, bt=64))
    j_ref = np.asarray(jref.sparse_row_sample_ref(*args))
    # the reference's own pair: its wrapper pads J to a multiple of bs, and
    # XLA's cumsum over the wider row may round differently, so they too
    # differ at near-ties (at J = 352, row 79, a target on the mass: the
    # kernel returns the sentinel 1000, the oracle 975)
    _near_tie_mismatches(vals, tgt, j_kernel, j_ref, topics)
    for want in (j_kernel, j_ref):
        bad = _near_tie_mismatches(vals, tgt, got, want, topics)
        # targets placed exactly on a reference prefix sum (every 5th row)
        # or on the float64 mass (rows 2 mod 7) make the ties; elsewhere
        # at most one row in 300 may
        elsewhere = bad[(bad % 5 != 0) & (bad % 7 != 2)]
        assert elsewhere.size <= 1, (bad.size, elsewhere)


def test_prefix_sums_follow_the_kernel_order():
    """The oracle's prefix sums: a strip-wise shuffle scan plus the carry,
    not a left-to-right sum; both are within float32 rounding of the
    exact prefix, and the first strip of 32 equals the scan alone."""
    rng = np.random.default_rng(7)
    vals = rng.random((50, 100)).astype(np.float32)
    pre = ref.sparse_row_prefix_ref(torch.from_numpy(vals)).numpy()
    exact = np.cumsum(vals.astype(np.float64), axis=1)
    np.testing.assert_allclose(pre, exact, rtol=2e-6)
    strip = sparse_row.strip_scan(torch.from_numpy(vals[:, :32])).numpy()
    np.testing.assert_array_equal(pre[:, :32], strip)


def test_tiles_change_nothing_and_no_launch_is_counted_on_cpu():
    vals, topics, tgt = _rows(3, 64, 40)
    ops.reset_launch_counts()
    base = _port(ops.sparse_row_sample, vals, topics, tgt)
    for bt, bs in ((8, 128), (256, 256), (1024, 512)):
        got = ops.sparse_row_sample(torch.from_numpy(vals),
                                    torch.from_numpy(topics),
                                    torch.from_numpy(tgt), bt=bt, bs=bs)
        np.testing.assert_array_equal(got.numpy(), base)
    assert ops.launch_counts()["sparse_row_sample"] == 0


def test_cuda_wrapper_validates_before_launch():
    vals, topics, tgt = (torch.from_numpy(a) for a in _rows(4, 8, 5))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        sparse_row.sparse_row_sample_cuda(vals, topics, tgt)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.sparse_row_sample(vals.to("meta"), topics.to("meta"),
                              tgt.to("meta"))
