"""Kernel 5, the signed topic-delta histogram, against the JAX package.

Integer sums are exact in any order, so the port's ``ops.topic_histogram``
(its plain version on the CPU: two accumulating ``index_put_``), its
oracle ``ref.topic_histogram_ref`` and the reference's
``ops.topic_histogram`` (its Pallas kernel in interpret mode) and
``ref.topic_histogram_ref`` must agree bit for bit. The reference's kernel
needs rows sorted (its tile ranks); the port's takes any order.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import counts as tcounts
from repro_torch.kernels import ops, ref, topic_histogram


def _inputs(seed, t, k, r, sort=True):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, r, t).astype(np.int32)
    if sort:
        rows = np.sort(rows)
    zo = rng.integers(0, k, t).astype(np.int32)
    zn = rng.integers(0, k, t).astype(np.int32)
    inc = rng.integers(0, 2, t).astype(np.int32)
    return rows, zo, zn, inc


def _port(fn, rows, zo, zn, inc, r, k, **kw):
    return fn(*(torch.from_numpy(a) for a in (rows, zo, zn, inc)), r, k,
              **kw).numpy()


def _jax(fn, rows, zo, zn, inc, r, k, **kw):
    return np.asarray(fn(*(jnp.asarray(a) for a in (rows, zo, zn, inc)),
                         r, k, **kw))


@pytest.mark.parametrize(
    "t,k,r",
    [(256, 512, 40), (100, 48, 7), (1024, 256, 200), (8, 16, 1), (33, 9, 5)],
)
def test_matches_reference_kernel_and_oracle(t, k, r):
    args = _inputs(t + k + r, t, k, r)
    got = _port(ops.topic_histogram, *args, r, k)
    assert got.dtype == np.int32 and got.shape == (r, k)
    np.testing.assert_array_equal(
        got, _jax(jops.topic_histogram, *args, r, k, bt=64, bk=128))
    np.testing.assert_array_equal(
        got, _jax(jref.topic_histogram_ref, *args, r, k))
    np.testing.assert_array_equal(
        got, _port(ref.topic_histogram_ref, *args, r, k))


@pytest.mark.parametrize("t,k,r", [(500, 30, 17), (64, 7, 64), (1, 3, 2)])
def test_unsorted_rows_match_the_reference_oracle(t, k, r):
    """The reference's kernel needs sorted rows; its scatter oracle and
    the port's kernel take any order."""
    args = _inputs(7 * t + k, t, k, r, sort=False)
    got = _port(ops.topic_histogram, *args, r, k)
    np.testing.assert_array_equal(
        got, _jax(jref.topic_histogram_ref, *args, r, k))
    np.testing.assert_array_equal(
        got, _port(ref.topic_histogram_ref, *args, r, k))
    # sorting the tokens (the reference's precondition) changes nothing
    order = np.argsort(args[0], kind="stable")
    sorted_args = [a[order] for a in args]
    np.testing.assert_array_equal(
        got, _jax(jops.topic_histogram, *sorted_args, r, k, bt=16, bk=128))


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 120), st.integers(2, 60), st.integers(1, 30),
       st.integers(0, 2 ** 20), st.booleans())
def test_property_sweep(t, k, r, seed, sort):
    args = _inputs(seed, t, k, r, sort=sort)
    got = _port(ops.topic_histogram, *args, r, k)
    np.testing.assert_array_equal(
        got, _jax(jref.topic_histogram_ref, *args, r, k))
    if sort:
        np.testing.assert_array_equal(
            got, _jax(jops.topic_histogram, *args, r, k, bt=16, bk=128))
    # row sums are zero: a move is (-1, +1) within the same row
    np.testing.assert_array_equal(got.sum(1), np.zeros(r, np.int32))


def test_equals_the_deltas_of_a_training_step():
    """With inc = (z_new != z_old), the doc-side histogram over tokens in
    doc order and the word-side one after a stable sort by word are
    ``delta_counts``' d_kd and d_wk."""
    rng = np.random.default_rng(3)
    d, w, k, t = 20, 50, 12, 600
    doc = np.sort(rng.integers(0, d, t)).astype(np.int32)
    word = rng.integers(0, w, t).astype(np.int32)
    zo = rng.integers(0, k, t).astype(np.int32)
    zn = np.where(rng.random(t) < 0.6, rng.integers(0, k, t), zo).astype(
        np.int32)
    tw, td, tzo, tzn = (torch.from_numpy(a) for a in (word, doc, zo, zn))
    inc = (tzn != tzo).to(torch.int32)
    d_wk, d_kd, _ = tcounts.delta_counts(tw, td, tzo, tzn, w, d, k)
    assert bool((td[1:] >= td[:-1]).all())
    assert torch.equal(ops.topic_histogram(td, tzo, tzn, inc, d, k), d_kd)
    order = torch.sort(tw, stable=True).indices
    assert torch.equal(ops.topic_histogram(tw[order], tzo[order], tzn[order],
                                           inc[order], w, k), d_wk)


def test_tiles_change_nothing_and_no_launch_is_counted_on_cpu():
    args = _inputs(11, 200, 40, 9)
    ops.reset_launch_counts()
    base = _port(ops.topic_histogram, *args, 9, 40)
    for bt, bk in ((8, 128), (1024, 512)):
        np.testing.assert_array_equal(
            _port(ops.topic_histogram, *args, 9, 40, bt=bt, bk=bk), base)
    assert ops.launch_counts()["topic_histogram"] == 0


def test_ids_out_of_range_are_refused():
    rows, zo, zn, inc = (torch.from_numpy(a) for a in _inputs(2, 16, 5, 4))
    for bad_rows, bad_zo, bad_zn in ((rows + 4, zo, zn), (rows - 4, zo, zn),
                                     (rows, zo + 5, zn), (rows, zo, zn - 5)):
        with pytest.raises(IndexError, match="outside"):
            ops.topic_histogram(bad_rows, bad_zo, bad_zn, inc, 4, 5)


def test_cuda_wrapper_validates_before_launch():
    rows, zo, zn, inc = (torch.from_numpy(a) for a in _inputs(4, 8, 5, 3))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        topic_histogram.topic_histogram_cuda(rows, zo, zn, inc, 3, 5)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.topic_histogram(rows.to("meta"), zo.to("meta"), zn.to("meta"),
                            inc.to("meta"), 3, 5)


@pytest.mark.parametrize("sort", [True, False])
def test_row_order_is_the_stable_row_major_walk(sort):
    rows = _inputs(21, 300, 5, 40, sort=sort)[0]
    walk = topic_histogram.row_order(torch.from_numpy(rows))
    if sort:  # already sorted: the tokens' own order, nothing stored
        assert walk.order is None
        np.testing.assert_array_equal(walk.rows.numpy(), rows)
    else:
        want = np.argsort(rows, kind="stable")
        assert walk.order.dtype == torch.int32
        np.testing.assert_array_equal(walk.order.numpy(), want)
        np.testing.assert_array_equal(walk.rows.numpy(), rows[want])


@pytest.mark.parametrize("t,k,r", [(700, 30, 25), (64, 7, 1), (1, 3, 2)])
def test_walk_and_unit_weights_change_nothing(t, k, r):
    """``order`` only chooses the kernel's walk, and ``inc=None`` is a
    weight of one per token: the results equal the reference oracle's."""
    rows, zo, zn, _ = _inputs(3 * t + k, t, k, r, sort=False)
    ones = np.ones(t, np.int32)
    want = _jax(jref.topic_histogram_ref, rows, zo, zn, ones, r, k)
    tr, tzo, tzn = (torch.from_numpy(a) for a in (rows, zo, zn))
    for order in (None, topic_histogram.row_order(tr)):
        got = ops.topic_histogram(tr, tzo, tzn, None, r, k, order=order)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        topic_histogram.topic_histogram_plain(tr, tzo, tzn, None, r,
                                              k).numpy(), want)


def test_cuda_wrapper_checks_the_walk_before_launch():
    rows, zo, zn, inc = (torch.from_numpy(a) for a in _inputs(4, 8, 5, 3))
    walk = topic_histogram.RowOrder(rows, rows,
                                    torch.arange(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        topic_histogram.topic_histogram_cuda(rows, zo, zn, None, 3, 5,
                                             order=walk)


def test_cuda_wrapper_refuses_a_walk_of_other_rows():
    """A walk serves only the rows it was built from: one of other rows of
    the same length is refused before anything else is checked."""
    rows, zo, zn, _ = (torch.from_numpy(a)
                       for a in _inputs(6, 8, 5, 3, sort=False))
    other = topic_histogram.row_order(rows.flip(0).contiguous())
    assert torch.equal(topic_histogram.row_order(rows).source, rows)
    with pytest.raises(ValueError, match="other rows"):
        topic_histogram.topic_histogram_cuda(rows, zo, zn, None, 3, 5,
                                             order=other)
