"""Fused gather + sample, for serving and for training.

The gathered-row samplers read (T, K) rows that a caller materialised as
``n_wk[word]`` / ``n_kd[slot or doc]``. These variants read each token's
rows straight out of the resident matrices, so no (T, K) intermediate
exists. ``zen_fused_infer_sample_cuda`` launches ``zen_infer_fused``
(``csrc/zen_infer.cu``; ``zen_infer_exact_cuda``, test-only, its exact
loop alone) and ``zen_fused_sample_cuda`` launches
``zen_train_fused`` (``csrc/zen_train.cu``); each shares its scoring
routine with its gathered kernel, so the two are bit-identical on the
card, as the reference requires of its Pallas kernels. The ``_plain``
functions are the same functions in plain torch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.zen_sampler import (
    PLAIN_CHUNK,
    check_cuda_args,
    check_seed,
    infer_argmax_rows,
    infer_launch_extras,
    noise_rows,
    train_argmax_rows,
    train_launch_extras,
)


def zen_fused_infer_sample_plain(n_wk, n_kd, word, slot, z_old, seeds,
                                 alpha_k, n_k, *, beta: float,
                                 w_beta: float) -> torch.Tensor:
    """Plain-torch version: gathers one chunk of rows at a time."""
    alpha = alpha_k.to(torch.float32)
    denom = n_k.to(torch.float32) + w_beta
    word, slot = word.long(), slot.long()
    out = torch.empty(word.shape[0], dtype=torch.int32, device=n_wk.device)
    for s in range(0, word.shape[0], PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        out[s:e] = infer_argmax_rows(
            n_wk[word[s:e]], n_kd[slot[s:e]], z_old[s:e], seeds[s:e],
            alpha, denom, beta,
        )
    return out


def _check_infer_args(n_wk, n_kd, word, slot, z_old, seeds, alpha_k, n_k):
    """The fused serving launchers' checks; returns (T, K, W, B)."""
    i32, f32 = torch.int32, torch.float32
    check_cuda_args(
        [("n_wk", n_wk), ("n_kd", n_kd), ("word", word), ("slot", slot),
         ("z_old", z_old), ("seeds", seeds), ("alpha_k", alpha_k),
         ("n_k", n_k)],
        [i32, i32, i32, i32, i32, i32, f32, f32],
    )
    (w, k), (b, kd), t = n_wk.shape, n_kd.shape, word.shape[0]
    if kd != k or any(x.shape != (t,) for x in (word, slot, z_old, seeds)) \
            or alpha_k.shape != (k,) or n_k.shape != (k,):
        raise ValueError(
            f"shape mismatch: n_wk {tuple(n_wk.shape)}, n_kd "
            f"{tuple(n_kd.shape)}, token vectors of {t}, alpha_k "
            f"{tuple(alpha_k.shape)}, n_k {tuple(n_k.shape)}"
        )
    return t, k, w, b


def zen_fused_infer_sample_cuda(n_wk, n_kd, word, slot, z_old, seeds,
                                alpha_k, n_k, *, beta: float,
                                w_beta: float, stats=None) -> torch.Tensor:
    """Launch ``zen_infer_fused`` on the current stream; no sync. A word
    or slot id outside its matrix aborts the kernel, and the caller's next
    synchronize raises, as the plain version's indexing does on the card.
    ``stats``: see :func:`repro_torch.kernels.zen_sampler.launch_extras`.
    """
    from repro_torch.kernels._build import check_launch, library

    t, k, w, b = _check_infer_args(n_wk, n_kd, word, slot, z_old, seeds,
                                   alpha_k, n_k)
    out = torch.empty(t, dtype=torch.int32, device=n_wk.device)
    scratch, extras = infer_launch_extras(k, n_wk.device, stats)
    stream = torch.cuda.current_stream(n_wk.device).cuda_stream
    with torch.cuda.device(n_wk.device):
        check_launch("zen_infer_fused", library().zen_infer_fused(
            n_wk.data_ptr(), n_kd.data_ptr(), word.data_ptr(),
            slot.data_ptr(), z_old.data_ptr(), seeds.data_ptr(),
            alpha_k.data_ptr(), n_k.data_ptr(), out.data_ptr(),
            t, k, w, b, ctypes.c_float(beta), ctypes.c_float(w_beta),
            *extras, stream,
        ))
    return out


def zen_infer_exact_cuda(n_wk, n_kd, word, slot, z_old, seeds, alpha_k,
                         n_k, *, beta: float, w_beta: float) -> torch.Tensor:
    """Launch ``zen_infer_exact``, the exact loop alone over every token
    (test-only: the draws the verified serving kernels must keep; gathered
    rows go in as ``n_wk``/``n_kd`` with ``word = slot = arange(T)``), on
    the current stream; no sync."""
    from repro_torch.kernels._build import check_launch, library

    t, k, w, b = _check_infer_args(n_wk, n_kd, word, slot, z_old, seeds,
                                   alpha_k, n_k)
    out = torch.empty(t, dtype=torch.int32, device=n_wk.device)
    stream = torch.cuda.current_stream(n_wk.device).cuda_stream
    with torch.cuda.device(n_wk.device):
        check_launch("zen_infer_exact", library().zen_infer_exact(
            n_wk.data_ptr(), n_kd.data_ptr(), word.data_ptr(),
            slot.data_ptr(), z_old.data_ptr(), seeds.data_ptr(),
            alpha_k.data_ptr(), n_k.data_ptr(), out.data_ptr(),
            t, k, w, b, ctypes.c_float(beta), ctypes.c_float(w_beta),
            stream,
        ))
    return out


def zen_fused_sample_plain(n_wk, n_kd, word, doc, z_old, alpha_k, n_k,
                           seed: int, *, beta: float, w_beta: float,
                           row_offset: int = 0,
                           token_index=None) -> torch.Tensor:
    """Plain-torch version of the fused training kernel: gathers one chunk
    of rows at a time; token t's noise row is ``token_index[t]`` where
    given, else ``row_offset + t``."""
    alpha = alpha_k.to(torch.float32)
    nk = n_k.to(torch.float32)
    word, doc = word.long(), doc.long()
    t = word.shape[0]
    out = torch.empty(t, dtype=torch.int32, device=n_wk.device)
    for s in range(0, t, PLAIN_CHUNK):
        e = min(s + PLAIN_CHUNK, t)
        rows = noise_rows(s, e, row_offset, token_index, n_wk.device)
        out[s:e] = train_argmax_rows(
            n_wk[word[s:e]], n_kd[doc[s:e]], z_old[s:e], rows, seed, alpha,
            nk, beta, w_beta,
        )
    return out


def zen_fused_sample_cuda(n_wk, n_kd, word, doc, z_old, alpha_k, n_k,
                          seed: int, *, beta: float, w_beta: float,
                          row_offset: int = 0, token_index=None,
                          stats=None) -> torch.Tensor:
    """Launch ``zen_train_fused`` on the current stream; no sync. A word
    or doc id outside its matrix aborts the kernel, and the caller's next
    synchronize raises. ``token_index``: (T,) int32 noise rows, else
    ``row_offset + t``. ``stats``: see
    :func:`repro_torch.kernels.zen_sampler.train_launch_extras`."""
    from repro_torch.kernels._build import check_launch, library

    i32, f32 = torch.int32, torch.float32
    check_cuda_args(
        [("n_wk", n_wk), ("n_kd", n_kd), ("word", word), ("doc", doc),
         ("z_old", z_old), ("alpha_k", alpha_k), ("n_k", n_k)],
        [i32, i32, i32, i32, i32, f32, f32],
    )
    (w, k), (d, kd), t = n_wk.shape, n_kd.shape, word.shape[0]
    if kd != k or any(x.shape != (t,) for x in (word, doc, z_old)) \
            or alpha_k.shape != (k,) or n_k.shape != (k,):
        raise ValueError(
            f"shape mismatch: n_wk {tuple(n_wk.shape)}, n_kd "
            f"{tuple(n_kd.shape)}, token vectors of {t}, alpha_k "
            f"{tuple(alpha_k.shape)}, n_k {tuple(n_k.shape)}"
        )
    check_seed(seed, row_offset, t, token_index)
    if token_index is not None:
        check_cuda_args([("token_index", token_index)], [i32])
    out = torch.empty(t, dtype=i32, device=n_wk.device)
    scratch, extras = train_launch_extras(k, n_wk.device, stats)
    stream = torch.cuda.current_stream(n_wk.device).cuda_stream
    with torch.cuda.device(n_wk.device):
        check_launch("zen_train_fused", library().zen_train_fused(
            n_wk.data_ptr(), n_kd.data_ptr(), word.data_ptr(),
            doc.data_ptr(), z_old.data_ptr(), alpha_k.data_ptr(),
            n_k.data_ptr(), out.data_ptr(), t, k, w, d, int(seed),
            int(row_offset),
            None if token_index is None else token_index.data_ptr(),
            ctypes.c_float(beta), ctypes.c_float(w_beta),
            *extras, stream,
        ))
    return out
