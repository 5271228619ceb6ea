"""The port's CUDA kernels on the card (marker ``gpu``; they skip without
one). Run them where a card is:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

This file imports no JAX, so it also runs where JAX is not installed
(``--noconftest`` skips the suite's JAX fixtures).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.fused_gather import zen_fused_infer_sample_plain
from repro_torch.kernels.zen_sampler import gumbel_noise

pytestmark = pytest.mark.gpu
NEAR_TIE = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(dev, seed, t, k, w, b):
    g = torch.Generator(device=dev).manual_seed(seed)
    i32 = torch.int32
    n_wk = torch.randint(0, 50, (w, k), generator=g, device=dev, dtype=i32)
    return dict(
        n_wk=n_wk,
        n_kd=torch.randint(0, 9, (b, k), generator=g, device=dev, dtype=i32),
        word=torch.randint(0, w, (t,), generator=g, device=dev, dtype=i32),
        slot=torch.randint(0, b, (t,), generator=g, device=dev, dtype=i32),
        z=torch.randint(0, k, (t,), generator=g, device=dev, dtype=i32),
        seeds=torch.randint(0, 2**31 - 1, (t,), generator=g, device=dev,
                            dtype=i32),
        alpha=torch.rand(k, generator=g, device=dev) * 0.1,
        n_k=n_wk.sum(0).to(torch.float32),
    )


@pytest.mark.parametrize("t,k,w,b", [(4096, 1000, 20000, 8),
                                     (333, 37, 50, 3), (1, 5, 2, 1)])
def test_kernels_match_plain_version_on_card(cuda, t, k, w, b):
    a = _inputs(cuda, t + k, t, k, w, b)
    args = (a["n_wk"], a["n_kd"], a["word"], a["slot"], a["z"], a["seeds"],
            a["alpha"], a["n_k"])
    kw = dict(beta=0.01, w_beta=w * 0.01)
    before = ops.launch_counts()
    fused = ops.zen_fused_infer_sample(*args, **kw)
    gathered = ops.zen_infer_sample(
        a["n_wk"][a["word"].long()].contiguous(),
        a["n_kd"][a["slot"].long()].contiguous(), a["z"], a["seeds"],
        a["alpha"], a["n_k"], **kw)
    plain = zen_fused_infer_sample_plain(*args, **kw)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["zen_fused_infer_sample"] == \
        before["zen_fused_infer_sample"] + 1
    assert after["zen_infer_sample"] == before["zen_infer_sample"] + 1
    assert torch.equal(fused, gathered)
    bad = (fused != plain).nonzero().flatten().tolist()
    for i in bad:  # a mismatch must be a near-tie of the two scores
        cand = torch.tensor([int(fused[i]), int(plain[i])], device=cuda)
        wi, si = int(a["word"][i]), int(a["slot"][i])
        nd = a["n_kd"][si, cand].float() - (cand == a["z"][i]).float()
        p = (nd + a["alpha"][cand]) * (a["n_wk"][wi, cand].float() + 0.01) \
            / (a["n_k"][cand] + w * 0.01)
        s = torch.log(torch.clamp_min(p, 1e-30)) \
            + gumbel_noise(a["seeds"][i], 0, cand)
        assert abs(float(s[0] - s[1])) <= NEAR_TIE
    assert len(bad) <= max(1, t // 10000)


_OUT_OF_RANGE = """
import torch
from repro_torch.kernels import ops
d = torch.device("cuda", 0)
i32 = torch.int32
n_wk = torch.ones((10, 16), dtype=i32, device=d)
vec = torch.zeros(64, dtype=i32, device=d)
word = vec.clone()
word[5] = 10  # W
try:
    ops.zen_fused_infer_sample(
        n_wk, torch.ones((2, 16), dtype=i32, device=d), word, vec, vec, vec,
        torch.full((16,), 0.1, device=d), n_wk.sum(0).float(), beta=0.01,
        w_beta=0.1)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("RAISED", e)
"""


def test_out_of_range_word_raises(cuda):
    """Like the plain version's indexing, the fused kernel refuses a word
    outside n_wk. The abort leaves the CUDA context unusable, so it runs in
    a process of its own."""
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run([sys.executable, "-c", _OUT_OF_RANGE],
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": src})
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr


def test_engine_serves_through_the_fused_kernel(cuda):
    from repro_torch.serving import FrozenLDAModel, LDAEngine, LDAServeConfig

    n_wk = (np.eye(8, dtype=np.int32) * 80).repeat(10, 0)
    model = FrozenLDAModel.from_numpy(n_wk, n_wk.sum(0), {"num_topics": 8},
                                      device=cuda)
    docs = [np.arange(t * 10, t * 10 + 9) for t in range(8)]
    ops.reset_launch_counts()
    for mode in ("throughput", "latency"):
        thetas = LDAEngine(model, LDAServeConfig(
            buckets=(16,), mode=mode, algorithm="zen_pallas")
        ).infer_batch(docs)
        assert [int(np.argmax(th)) for th in thetas] == list(range(8))
    assert ops.launch_counts()["zen_fused_infer_sample"] > 0
