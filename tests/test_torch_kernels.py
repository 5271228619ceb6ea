"""The port's counter hash and serving samplers against the JAX package.

* The hash integers, the 24-bit uniforms, ``mix32`` and ``golden_seed`` are
  integer work: bit-equal to ``repro.kernels.zen_sampler`` over a grid of
  (seed, row, col).
* Gumbel noise goes through ``log`` twice, and torch's CPU ``log`` and
  XLA's do not agree in the last bits: finite values within 1e-4 (the
  largest gap seen; in practice ~1e-6), non-finite values equal.
* The samplers (plain torch on the CPU) against the reference's Pallas
  kernels in interpret mode, at several K tiles (bk=128): topics equal,
  where every mismatch must be a near-tie (the two topics' float32 scores
  within 1e-4) and there is at most one per 1000 tokens. Against the
  port's own ``ref.py`` oracles and between the fused and gathered paths:
  bit-equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import zen_sampler as jzs
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import zen_sampler as tzs

NEAR_TIE = 1e-4


def _grid():
    seeds = np.concatenate([
        np.array([0, 1, 7, 2**31 - 1, -1, -(2**31)], np.int64),
        np.random.default_rng(0).integers(0, 2**31 - 1, 58),
    ]).astype(np.int32)
    rows = np.arange(0, 40, dtype=np.int32)
    cols = np.concatenate([np.arange(0, 1000, 9), [2**31 - 1]]).astype(
        np.int32)
    return seeds[:, None, None], rows[None, :, None], cols[None, None, :]


def test_hash_bits_and_uniform_bit_equal_on_grid():
    s, r, c = _grid()
    j_bits = np.asarray(jzs._mix(
        jnp.asarray(s).astype(jnp.uint32)
        ^ (jnp.asarray(r).astype(jnp.uint32) * jnp.uint32(jzs._GOLD))
        ^ jzs._mix(jnp.asarray(c).astype(jnp.uint32))
    )).astype(np.int64)
    t_bits = tzs.hash_bits(torch.from_numpy(s), torch.from_numpy(r),
                           torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(t_bits, j_bits)
    j_u = np.asarray(jzs.hash_uniform(jnp.asarray(s), jnp.asarray(r),
                                      jnp.asarray(c)))
    t_u = tzs.hash_uniform(torch.from_numpy(s), torch.from_numpy(r),
                           torch.from_numpy(c)).numpy()
    assert t_u.dtype == np.float32
    np.testing.assert_array_equal(t_u, j_u)


def test_mix32_and_golden_seed_bit_equal():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        tzs.mix32(torch.from_numpy(x.astype(np.int64))).numpy(),
        np.asarray(jzs.mix32(jnp.asarray(x))).astype(np.int64),
    )
    hi = rng.integers(0, 2**32, (40, 1), dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, (40, 1), dtype=np.uint64).astype(np.uint32)
    pos = np.arange(600, dtype=np.uint32)[None, :]
    t = tzs.golden_seed(*(torch.from_numpy(a.astype(np.int64))
                          for a in (hi, lo, pos))).numpy()
    j = np.asarray(jzs.golden_seed(jnp.asarray(hi), jnp.asarray(lo),
                                   jnp.asarray(pos)))
    assert t.dtype == np.int32 and (t >= 0).all()
    np.testing.assert_array_equal(t, j)


def test_gumbel_noise_within_last_bits():
    """torch's first CPU ``log`` on a large tensor in a process that has
    run XLA computations can be off by ~4e-5 relative in one element (a
    torch fault, not the port's; ROADMAP queue 3). A throwaway call of that
    size takes it, and the port's noise is computed before the reference's
    XLA ``gumbel_noise`` runs here."""
    s, r, c = _grid()
    torch.log(torch.linspace(0.5, 1.0, s.size * r.size * c.size))
    t = tzs.gumbel_noise(torch.from_numpy(s), torch.from_numpy(r),
                         torch.from_numpy(c)).numpy()
    j = np.asarray(jzs.gumbel_noise(jnp.asarray(s), jnp.asarray(r),
                                    jnp.asarray(c)))
    fin = np.isfinite(j)
    np.testing.assert_array_equal(np.isfinite(t), fin)
    np.testing.assert_array_equal(t[~fin], j[~fin])
    gap = np.abs(t[fin] - j[fin])
    worst = int(np.argmax(gap))
    assert gap[worst] <= NEAR_TIE, (gap[worst], t[fin][worst], j[fin][worst])


def test_top_uniform_gives_plus_inf_noise_in_both():
    """A hash whose top 24 bits are all ones rounds u to 1.0: the noise is
    +inf (not -inf) in both packages, so that topic wins its draw."""
    u = np.float32(0xFFFFFF) * np.float32(1.0 / (1 << 24)) \
        + np.float32(0.5 / (1 << 24))
    assert u == np.float32(1.0)
    assert float(-jnp.log(-jnp.log(jnp.float32(u)))) == np.inf
    assert float(-torch.log(-torch.log(torch.tensor(u)))) == np.inf


def _inputs(seed, t, k, w, d):
    rng = np.random.default_rng(seed)
    return dict(
        n_wk=rng.integers(0, 40, (w, k)).astype(np.int32),
        n_kd=rng.integers(0, 8, (d, k)).astype(np.int32),
        word=rng.integers(0, w, t).astype(np.int32),
        slot=rng.integers(0, d, t).astype(np.int32),
        z=rng.integers(0, k, t).astype(np.int32),
        seeds=rng.integers(0, 2**31 - 1, t).astype(np.int32),
        ak=(rng.random(k) * 0.2 + 0.001).astype(np.float32),
    )


def _scores(a, beta, w_beta):
    """The port's float32 score matrix for inputs ``a`` (plain torch)."""
    k = a["n_wk"].shape[1]
    nw = torch.from_numpy(a["n_wk"][a["word"]]).float()
    cols = torch.arange(k)[None, :]
    hit = (cols == torch.from_numpy(a["z"])[:, None]).float()
    nd = torch.from_numpy(a["n_kd"][a["slot"]]).float() - hit
    nk = torch.from_numpy(a["n_wk"].sum(0).astype(np.float32))
    p = (nd + torch.from_numpy(a["ak"])) * (nw + beta) / (nk + w_beta)
    g = tzs.gumbel_noise(torch.from_numpy(a["seeds"])[:, None], 0, cols)
    return (torch.log(torch.clamp_min(p, 1e-30)) + g).numpy()


def near_tie_mismatches(port, jax_out, scores):
    """Indices where the topics differ; asserts each one is a near-tie."""
    bad = np.flatnonzero(port != jax_out)
    for i in bad:
        gap = abs(scores[i, port[i]] - scores[i, jax_out[i]])
        assert gap <= NEAR_TIE, (i, port[i], jax_out[i], gap)
    return bad


@pytest.mark.parametrize(
    "seed,t,k,w,d",
    [(0, 64, 200, 40, 4), (1, 48, 300, 120, 6), (2, 9, 200, 7, 3)],
)
def test_plain_samplers_match_reference_kernels(seed, t, k, w, d):
    a = _inputs(seed, t, k, w, d)
    nk = a["n_wk"].sum(0).astype(np.float32)
    beta, w_beta = 0.01, w * 0.01
    j_args = [jnp.asarray(a[n]) for n in ("n_wk", "n_kd", "word", "slot",
                                          "z", "seeds", "ak")]
    j_fused = np.asarray(jops.zen_fused_infer_sample(
        *j_args, jnp.asarray(nk), beta=beta, w_beta=w_beta, bt=8, bk=128))
    j_gath = np.asarray(jops.zen_infer_sample(
        jnp.asarray(a["n_wk"][a["word"]]), jnp.asarray(a["n_kd"][a["slot"]]),
        *j_args[4:], jnp.asarray(nk), beta=beta, w_beta=w_beta, bt=8,
        bk=128))
    np.testing.assert_array_equal(j_fused, j_gath)

    t_args = [torch.from_numpy(a[n]) for n in ("n_wk", "n_kd", "word",
                                               "slot", "z", "seeds", "ak")]
    nk_t = torch.from_numpy(nk)
    t_fused = ops.zen_fused_infer_sample(
        *t_args, nk_t, beta=beta, w_beta=w_beta, bt=8, bk=128).numpy()
    t_gath = ops.zen_infer_sample(
        torch.from_numpy(a["n_wk"][a["word"]]),
        torch.from_numpy(a["n_kd"][a["slot"]]),
        *t_args[4:], nk_t, beta=beta, w_beta=w_beta).numpy()
    t_ref = ref.zen_fused_infer_sample_ref(
        *t_args, nk_t, beta=beta, w_beta=w_beta).numpy()
    assert t_fused.dtype == np.int32
    np.testing.assert_array_equal(t_fused, t_gath)
    np.testing.assert_array_equal(t_fused, t_ref)

    bad = near_tie_mismatches(t_fused, j_fused, _scores(a, beta, w_beta))
    assert len(bad) <= t // 1000, bad


def test_plain_version_chunks_without_changing_draws(monkeypatch):
    """Chunking the plain version over tokens changes no draw."""
    a = _inputs(3, 50, 130, 30, 5)
    args = [torch.from_numpy(a[n]) for n in ("n_wk", "n_kd", "word",
                                             "slot", "z", "seeds", "ak")]
    nk = torch.from_numpy(a["n_wk"].sum(0).astype(np.float32))
    whole = ops.zen_fused_infer_sample(*args, nk, beta=0.01, w_beta=0.3)
    monkeypatch.setattr(tzs, "PLAIN_CHUNK", 7)
    monkeypatch.setattr("repro_torch.kernels.fused_gather.PLAIN_CHUNK", 7)
    chunked = ops.zen_fused_infer_sample(*args, nk, beta=0.01, w_beta=0.3)
    np.testing.assert_array_equal(whole.numpy(), chunked.numpy())


def test_wrappers_route_by_device_and_count_only_launches():
    a = _inputs(4, 8, 16, 5, 2)
    args = [torch.from_numpy(a[n]) for n in ("n_wk", "n_kd", "word",
                                             "slot", "z", "seeds", "ak")]
    nk = torch.from_numpy(a["n_wk"].sum(0).astype(np.float32))
    ops.reset_launch_counts()
    ops.zen_fused_infer_sample(*args, nk, beta=0.01, w_beta=0.05)
    assert ops.launch_counts() == {"zen_sample": 0, "zen_fused_sample": 0,
                                   "zen_infer_sample": 0,
                                   "zen_fused_infer_sample": 0,
                                   "sparse_row_sample": 0,
                                   "cdf_row_search": 0,
                                   "doc_row_search": 0,
                                   "cdf_uniforms": 0, "cdf_draws": 0,
                                   "cdf_remedy": 0,
                                   "topic_histogram": 0}
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.zen_fused_infer_sample(*meta, nk.to("meta"), beta=0.01,
                                   w_beta=0.05)


def test_cuda_launchers_validate_before_launch():
    """The kernel launchers refuse what the kernel cannot take — checked in
    Python, before any build or pointer reaches the card."""
    a = _inputs(5, 8, 16, 5, 2)
    rows = torch.from_numpy(a["n_wk"][a["word"]])
    z, seeds = torch.from_numpy(a["z"]), torch.from_numpy(a["seeds"])
    ak = torch.from_numpy(a["ak"])
    nk = rows.float().sum(0)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tzs.zen_infer_sample_cuda(rows, rows, z, seeds, ak, nk,
                                  beta=0.01, w_beta=0.05)


def test_build_flags_keep_ieee_numerics():
    """Parity with the reference needs the accurate logf, IEEE division
    and no contracted multiply-adds, compiled for sm_90a."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "fast_math" not in flags
    source = "".join(src.read_text() for src in _build.SOURCES)
    for fn in _build.SIGNATURES:
        assert f'extern "C" int {fn}(' in source
