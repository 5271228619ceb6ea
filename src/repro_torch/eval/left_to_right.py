"""Wallach-style left-to-right held-out evaluation, particle estimate
(``repro/eval/left_to_right.py``), swept on the model's device.

Estimates ``log p(w_1..w_L | N_wk, N_k, hyper)`` for a held-out document
under the frozen-model predictive process: topics follow the Polya-urn
doc prior ``p(z_n = k | z_{<n}) ∝ count_{<n}(k) + alpha_k`` and words the
frozen ``phi_wk = (N_wk + beta)/(N_k + W beta)``. R particles are swept
position by position (Wallach et al. 2009, Alg. 1)::

    for n = 1..L:
        resample z_{<n} for every particle (the full variant)
        p_n^{(r)} = sum_k p(z=k | z^{(r)}_{<n}) phi[w_n, k]
        draw z^{(r)}_n ∝ p(z=k | z^{(r)}_{<n}) phi[w_n, k]
    log p(w) ≈ sum_n log mean_r p_n^{(r)}

The uniforms come from the same numpy ``Generator`` stream the reference
consumes, in its order: for each n, one ``random(R)`` per m < n, then one
for position n. They are drawn up front on the host and sent to the
device once. :func:`left_to_right_llh_batch` sweeps many documents,
padded and masked, in one lockstep of L(L+1)/2 steps. The counts are
integer-valued float64 and exact; a draw can differ from the reference's
only where its target lies within the cumulative sum's rounding of a
bucket edge (the device's ``cumsum`` adds in another order than numpy's).
Such near-ties are counted per document and returned, never hidden: a
document with none draws exactly the reference's particles.

``exhaustive_llh`` (the K^L enumeration the tests pin the estimate
against) stays on the host.
"""
from __future__ import annotations

from itertools import product
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import as_device_tensor


def _alpha_k(n_k: torch.Tensor, hyper) -> torch.Tensor:
    """``LDAHyperParams.alpha_k`` of the frozen n_k, in float64."""
    k = hyper.num_topics
    if not hyper.asymmetric_alpha:
        return torch.full((k,), hyper.alpha, dtype=torch.float64,
                          device=n_k.device)
    n_k = n_k.to(torch.float64)
    return (k * hyper.alpha) * (n_k + hyper.alpha_prime / k) / (
        n_k.sum() + hyper.alpha_prime)


def _draws(n: int, resample: bool) -> int:
    """Uniform rows (of R each) a length-``n`` document consumes."""
    return n * (n + 1) // 2 if resample else n


def _categorical(weights: torch.Tensor, u: torch.Tensor,
                 active: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One draw per row of unnormalized (N, R, K) ``weights`` at uniforms
    ``u`` (N, R), as the reference's ``_categorical_rows``; also, per
    document, the number of active rows whose target lies within the
    sum's rounding of a bucket edge (a near-tie)."""
    cdf = torch.cumsum(weights, dim=-1)
    total = cdf[..., -1:]
    target = u[..., None] * total
    k = weights.shape[-1]
    idx = (cdf < target).sum(-1).clamp_(max=k - 1)
    # each side's prefix sums lie within (K - 1) 2^-53 total of the exact
    # ones, and its target within as much again: two orders of addition
    # can put cdf - target on other sides of 0 only within 2K 2^-52 total
    tol = 2 * k * 2.0 ** -52
    near = ((cdf - target).abs() <= tol * total).any(-1) & active
    return idx, near.sum(-1)


def left_to_right_llh_batch(
    n_wk, n_k, docs: Sequence, hyper, num_particles: int = 20,
    rngs: Optional[Sequence[np.random.Generator]] = None,
    resample: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Left-to-right estimates of many documents at once, on ``n_wk``'s
    device.

    Args:
        n_wk: (W, K) frozen word-topic counts (a tensor stays on its
            device; numpy goes to ``device``).
        n_k: (K,) frozen topic totals.
        docs: token word ids of each held-out document.
        hyper: ``LDAHyperParams`` (alpha_k derives from the frozen n_k).
        num_particles: R.
        rngs: one seeded ``np.random.Generator`` per document (default: a
            fresh ``default_rng()`` each).
        resample: the full variant (resweep ``z_{<n}`` before every
            position); False is the O(L) variant.
        device: where a numpy ``n_wk`` is swept: the card unless the
            caller asks for the CPU.

    Returns:
        ``(llh, near_ties)``: the (N,) float64 estimates, each equal to
        ``left_to_right_llh`` of its document and generator, and per
        document the (N,) int64 number of draws taken at a near-tie.
    """
    n_wk = as_device_tensor(n_wk, device)
    dev = n_wk.device
    n_k = as_device_tensor(n_k, dev)
    docs = [np.asarray(d).reshape(-1) for d in docs]
    lens = [len(d) for d in docs]
    nd, r, k = len(docs), int(num_particles), hyper.num_topics
    if rngs is None:
        rngs = [np.random.default_rng() for _ in docs]
    out = np.zeros(nd, np.float64)
    lmax = max(lens, default=0)
    if lmax == 0:
        return out, np.zeros(nd, np.int64)
    # the uniforms, in each document's own stream order
    smax = _draws(lmax, resample)
    u_host = np.zeros((nd, smax, r), np.float64)
    for i, (n, rng) in enumerate(zip(lens, rngs)):
        if n:
            u_host[i, :_draws(n, resample)] = rng.random(
                (_draws(n, resample), r))
    u = torch.as_tensor(u_host, device=dev)
    words = np.zeros((nd, lmax), np.int64)
    for i, d in enumerate(docs):
        words[i, :len(d)] = d
    alpha_k = _alpha_k(n_k, hyper)
    alpha_sum = float(alpha_k.cpu().numpy().sum())
    w_beta = n_wk.shape[0] * hyper.beta
    phi = (n_wk[torch.as_tensor(words, device=dev)].to(torch.float64)
           + hyper.beta) / (n_k.to(torch.float64) + w_beta)  # (N, L, K)
    lens_t = torch.as_tensor(lens, device=dev)
    z = torch.zeros((nd, r, lmax), dtype=torch.int64, device=dev)
    counts = torch.zeros((nd, r, k), dtype=torch.float64, device=dev)
    total = torch.zeros(nd, dtype=torch.float64, device=dev)
    near = torch.zeros(nd, dtype=torch.int64, device=dev)

    def move(col: torch.Tensor, active: torch.Tensor, sign: float):
        # +-1 at each active particle's topic (integer-valued float64)
        step = (active.to(torch.float64) * sign)[:, None, None]
        counts.scatter_add_(2, col[..., None], step.expand(nd, r, 1))

    for n in range(lmax):
        active = lens_t > n  # (N,)
        act_r = active[:, None].expand(nd, r)
        row = n * (n + 1) // 2 if resample else n
        if resample:
            for m in range(n):
                move(z[:, :, m], active, -1.0)
                probs = (counts + alpha_k) * phi[:, m][:, None, :]
                draw, ties = _categorical(probs, u[:, row + m], act_r)
                near += ties
                z[:, :, m] = torch.where(act_r, draw, z[:, :, m])
                move(z[:, :, m], active, 1.0)
            row += n
        weights = (counts + alpha_k) * phi[:, n][:, None, :]
        p_n = weights.sum(-1) / (n + alpha_sum)  # (N, R)
        gain = torch.log(p_n.mean(-1).clamp(min=1e-300))
        total += torch.where(active, gain, torch.zeros_like(gain))
        draw, ties = _categorical(weights, u[:, row], act_r)
        near += ties
        z[:, :, n] = torch.where(act_r, draw, z[:, :, n])
        move(z[:, :, n], active, 1.0)
    out[:] = total.cpu().numpy()
    return out, near.cpu().numpy()


def left_to_right_llh(
    n_wk, n_k, words, hyper, num_particles: int = 20,
    rng: Optional[np.random.Generator] = None, resample: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> float:
    """Particle left-to-right estimate of ``log p(words | model)`` for one
    document (the reference's signature, plus ``device``), on ``n_wk``'s
    device (a numpy ``n_wk``: on ``device``, the card by default)."""
    rng = rng if rng is not None else np.random.default_rng()
    llh, _ = left_to_right_llh_batch(n_wk, n_k, [words], hyper,
                                     num_particles=num_particles,
                                     rngs=[rng], resample=resample,
                                     device=device)
    return float(llh[0])


def _host_alpha_k(n_k: np.ndarray, hyper) -> np.ndarray:
    k = hyper.num_topics
    if not hyper.asymmetric_alpha:
        return np.full(k, hyper.alpha, np.float64)
    n_k = np.asarray(n_k, np.float64)
    return (k * hyper.alpha) * (n_k + hyper.alpha_prime / k) / (
        n_k.sum() + hyper.alpha_prime)


def exhaustive_llh(n_wk, n_k, words, hyper) -> float:
    """Exact ``log p(words | model)`` by K^L enumeration on the host (test
    oracle; feasible only for short documents)."""
    n_wk = (n_wk.cpu().numpy() if isinstance(n_wk, torch.Tensor)
            else np.asarray(n_wk)).astype(np.float64)
    n_k = (n_k.cpu().numpy() if isinstance(n_k, torch.Tensor)
           else np.asarray(n_k)).astype(np.float64)
    words = np.asarray(words)
    l = int(words.shape[0])
    if l == 0:
        return 0.0
    k = hyper.num_topics
    assert k ** l <= 2_000_000, "enumeration oracle: document too long"
    alpha_k = _host_alpha_k(n_k, hyper)
    alpha_sum = float(alpha_k.sum())
    phi = (n_wk[words] + hyper.beta) / (
        n_k + n_wk.shape[0] * hyper.beta)[None, :]
    total = 0.0
    for assign in product(range(k), repeat=l):
        counts = np.zeros(k, np.float64)
        p = 1.0
        for n, zn in enumerate(assign):
            p *= (counts[zn] + alpha_k[zn]) / (n + alpha_sum) * phi[n, zn]
            counts[zn] += 1.0
        total += p
    return float(np.log(total))
