"""The port's serving samplers (queue-2 kernels 3 and 4) against the JAX
package, on the CPU, at the coordinates of chip_smoke.py's serving grid.

The verified CUDA serving sampler scores exactly the topics whose hash
lands in the top bucket m >= 2^24 - 2^12 (m = h >> 8, h the hash of
(seed, 0, topic)), m = 2^24 - 1 among them (noise +inf), clamps the
token's z_old at p = 1e-30 where its doc count is 0, and must keep the
lower topic on exact ties. ``SERVE_ADVERSARIAL`` pins a token on each of
these cases; here the pins' hash coordinates give the reference's bits,
and the plain version and both reference oracles
(``ref.zen_infer_sample_ref``, ``ref.zen_fused_infer_sample_ref``) draw
the pinned topics. The launchers' own checks run before any launch.
"""
import pathlib
import re
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import zen_sampler as jzs
from repro_torch.kernels import _build, ref
from repro_torch.kernels import fused_gather as tfg
from repro_torch.kernels import zen_sampler as tzs

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repo's root; stdlib-only at import)

NEAR_TIE = 1e-4
TOP_BUCKET = (1 << 24) - (1 << 12)
PINNED = [spec for spec in chip_smoke.SERVE_ADVERSARIAL if spec[7]]


def _reference_bits(seed, col):
    """The reference's hash of the serving coordinate (seed, 0, col)."""
    return int(jzs._mix(jnp.uint32(seed) ^ (jnp.uint32(0)
                                            * jnp.uint32(jzs._GOLD))
                        ^ jzs._mix(jnp.uint32(col))))


def _lane(k):
    """The lane that reads topic k at K % 4 == 0 (4 topics per lane)."""
    return (k & 127) >> 2


@pytest.mark.parametrize("seed,col,m", [
    (38296, 415, (1 << 24) - 1),  # +inf noise, topic < K = 1000
    (1003, 325, 16774212),  # the forced top bucket
    (141959, 156, 16773846), (141959, 406, 16773845),  # tie in the bucket
    (1025, 402, 10244105), (1025, 713, 10244105),  # tie, two lanes
    (1339, 696, 7458788), (1339, 826, 7458788),  # tie, one lane
])
def test_serving_pinned_hash_coordinates_match_reference(seed, col, m):
    port = int(tzs.hash_bits(seed, 0, col))
    assert port == _reference_bits(seed, col)
    assert port >> 8 == m
    assert (m >= TOP_BUCKET) == (seed in (38296, 1003, 141959))
    u_port = tzs.hash_uniform(seed, 0, col).numpy()
    u_ref = np.asarray(jzs.hash_uniform(jnp.int32(seed), jnp.int32(0),
                                        jnp.int32(col)))
    assert u_port.view(np.uint32) == u_ref.view(np.uint32)
    g = float(tzs.gumbel_noise(seed, 0, torch.tensor(col)))
    assert (g == np.inf) == (m == (1 << 24) - 1)


def test_serving_pinned_ties_share_one_uniform_in_their_lanes():
    """Each tied pair has one noise value; the candidates pair lies in two
    lanes, the same-lane pair in one (the kernel's 4-topic layout)."""
    for seed, a, b, same_lane in ((141959, 156, 406, None),
                                  (1025, 402, 713, False),
                                  (1339, 696, 826, True)):
        g = tzs.gumbel_noise(seed, 0, torch.tensor([a, b]))
        assert float(g[0]) == float(g[1]) and np.isfinite(float(g[0]))
        if same_lane is not None:
            assert (_lane(a) == _lane(b)) == same_lane
    assert (_lane(402), _lane(713), _lane(696)) == (4, 18, 14)


def test_serving_grid_covers_the_widths_and_the_table_boundary():
    """K = 1, 5, 37 and 1000, a partial pass (36), and K on both sides of
    the shared-memory table's limit on an H100 (14,464 entries of 16
    bytes fit 232,448 bytes; 14,592 do not), with 4 and 1 topics per
    lane above it."""
    ks = {spec[3] for spec in chip_smoke.SERVE_ADVERSARIAL}
    assert {1, 5, 37, 36, 1000, 14464, 14592, 16385} <= ks
    assert 14464 * 16 <= 232448 < 14592 * 16
    pins = {spec[0]: spec[7] for spec in PINNED}
    assert set(pins) == {"inf_noise", "top_bucket", "top_bucket_tie",
                         "candidates_tie", "same_lane_tie"}


def _case(spec):
    a = chip_smoke.serve_adversarial_case(spec, torch.device("cpu"))
    assert a["n_wk"].dtype == torch.int32 and a["z"].dtype == torch.int32
    return a


def _scores(a, rows):
    """The port's float32 serving scores of the tokens ``rows``."""
    word, slot = a["word"][rows].long(), a["slot"][rows].long()
    nw = a["n_wk"][word].float()
    k = nw.shape[1]
    cols = torch.arange(k)[None, :]
    hit = (cols == a["z"][rows].long()[:, None]).float()
    nd = a["n_kd"][slot].float() - hit
    p = (nd + a["alpha"][None, :]) * (nw + a["beta"]) \
        / (a["n_k"][None, :] + a["w_beta"])
    g = tzs.gumbel_noise(a["seeds"][rows][:, None], 0, cols)
    return torch.log(torch.clamp_min(p, 1e-30)) + g


def _draws(a):
    """(port plain, port oracle, reference fused oracle, reference
    gathered-row oracle) on the case's inputs."""
    args = tuple(a[n] for n in ("n_wk", "n_kd", "word", "slot", "z",
                                "seeds", "alpha", "n_k"))
    kw = dict(beta=a["beta"], w_beta=a["w_beta"])
    plain = tfg.zen_fused_infer_sample_plain(*args, **kw).numpy()
    port_ref = ref.zen_fused_infer_sample_ref(*args, **kw).numpy()
    j_fused = np.asarray(jref.zen_fused_infer_sample_ref(
        *(jnp.asarray(x.numpy()) for x in args), **kw))
    rows = (a["n_wk"][a["word"].long()], a["n_kd"][a["slot"].long()])
    j_rows = np.asarray(jref.zen_infer_sample_ref(
        *(jnp.asarray(x.numpy()) for x in rows + args[4:]), **kw))
    return plain, port_ref, j_fused, j_rows


@pytest.mark.parametrize("spec", PINNED, ids=[spec[0] for spec in PINNED])
def test_plain_version_and_reference_oracles_draw_the_serving_pins(spec):
    """The +inf winner (also as a z_old clamped at p = 1e-30), the forced
    bucket topic and the lower topic of each exact tie, in the port's
    plain version and oracle and in the reference's two oracles; elsewhere
    they may part only at near-ties (torch's and XLA's CPU log)."""
    a = _case(spec)
    plain, port_ref, j_fused, j_rows = _draws(a)
    np.testing.assert_array_equal(plain, port_ref)
    np.testing.assert_array_equal(j_fused, j_rows)
    for tok, seed, topics, z_old in spec[7]:
        assert int(a["seeds"][tok]) == seed and int(a["z"][tok]) == z_old
        want = min(topics)
        assert plain[tok] == want and j_fused[tok] == want, (spec[0], tok)
        if z_old in topics:  # the clamped z_old: N_kd = 0, so p <= 0
            assert int(a["n_kd"][int(a["slot"][tok]), z_old]) == 0
            s = _scores(a, torch.tensor([tok]))[0]
            assert float(s[z_old]) == np.inf
    bad = np.flatnonzero(plain != j_fused)
    if bad.size:
        s = _scores(a, torch.from_numpy(bad))
        for j, i in enumerate(bad):
            gap = abs(float(s[j, plain[i]] - s[j, j_fused[i]]))
            assert gap <= NEAR_TIE, (spec[0], i, gap)
    assert bad.size <= max(1, spec[2] // 1000)


def test_padding_case_clamps_z_old_and_matches_the_reference():
    """The grid's padding case is the engine's bucket state: documents of
    1 to 512 tokens, z_old stale past each, n_kd counting the documents
    alone. Many padding tokens then have N_kd = 0 at z_old, so both their
    estimate and their exact score clamp p at 1e-30; the plain version
    draws the reference oracle's topics there up to near-ties."""
    spec = next(s for s in chip_smoke.SERVE_ADVERSARIAL
                if s[0] == "padding")
    a = _case(spec)
    at_z = a["n_kd"][a["slot"].long(), a["z"].long()]
    assert int((at_z == 0).sum()) > spec[2] // 10
    lengths = a["n_kd"].sum(1)
    assert int(lengths.min()) >= 1 and int(lengths.max()) <= spec[2] // spec[5]
    plain, port_ref, j_fused, _ = _draws(a)
    np.testing.assert_array_equal(plain, port_ref)
    bad = np.flatnonzero(plain != j_fused)
    if bad.size:
        s = _scores(a, torch.from_numpy(bad))
        for j, i in enumerate(bad):
            assert abs(float(s[j, plain[i]] - s[j, j_fused[i]])) <= NEAR_TIE
    assert bad.size <= max(1, spec[2] // 1000)


def test_serving_launchers_check_their_arguments_before_launch(monkeypatch):
    """The stats output and the tensors are checked before any build or
    launch; the global table's scratch is allocated only where the
    library puts the serving table in global memory."""
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tzs.infer_launch_extras(8, cpu, torch.zeros(3, dtype=torch.int64))
    monkeypatch.setattr(tzs, "infer_global_table_entries", lambda k, d: 0)
    assert tzs.infer_launch_extras(1000, cpu, None) == (None, (None, None))
    monkeypatch.setattr(tzs, "infer_global_table_entries",
                        lambda k, d: -(-k // 128) * 128)
    scratch, (ptr, stats) = tzs.infer_launch_extras(14592, cpu, None)
    assert scratch.shape == (14592, 4) and ptr == scratch.data_ptr()
    assert stats is None

    monkeypatch.setattr(_build, "library", lambda: pytest.fail(
        "a launcher reached the library before its checks"))
    a = _case(PINNED[0])
    args = tuple(a[n] for n in ("n_wk", "n_kd", "word", "slot", "z",
                                "seeds", "alpha", "n_k"))
    kw = dict(beta=0.01, w_beta=2.0)
    for launch in (tfg.zen_fused_infer_sample_cuda, tfg.zen_infer_exact_cuda):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            launch(*args, **kw)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tzs.zen_infer_sample_cuda(a["n_wk"][a["word"].long()],
                                  a["n_kd"][a["slot"].long()], a["z"],
                                  a["seeds"], a["alpha"], a["n_k"],
                                  stats=torch.zeros(3, dtype=torch.int64),
                                  **kw)
    with pytest.raises(ValueError, match="kernels must be"):
        tzs.fast_score_errors(cpu, "serve")


def test_serving_source_stays_self_contained():
    """zen_infer.cu traps on ids out of range, keeps size_t row offsets,
    includes no header of the repository (the build hashes the .cu file
    alone), and exports its launchers, the exact-loop launcher and the
    exhaustive check among them."""
    src = (pathlib.Path(_build.__file__).parent / "csrc"
           / "zen_infer.cu").read_text()
    assert src.count("__trap()") >= 2
    assert "(size_t)w * (size_t)K" in src and "(size_t)d * (size_t)K" in src
    assert "(size_t)t * (size_t)K" in src
    includes = re.findall(r'#include\s*([<"][^>"]+[>"])', src)
    assert includes and all(i.startswith("<") for i in includes), includes
    for fn in ("zen_infer_gathered", "zen_infer_fused", "zen_infer_exact",
               "zen_infer_global_table", "zen_infer_constants",
               "zen_infer_fast_error"):
        assert fn in _build.SIGNATURES
        assert f'extern "C" int {fn}(' in src
    # the exact loop the verified path falls back on is kept as it was
    assert "__device__ __forceinline__ int score_argmax(" in src
    assert "const float g = -logf(-logf(u));" in src
