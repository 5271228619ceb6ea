"""``zen_cdf``'s per-token uniforms, draws and remedy on the kernel route:
the steps around the doc-row search and kernel 7 (``cdf_search``), as
three kernels (``csrc/cdf_tokens.cu``).

A token chunk runs :func:`cdf_uniforms_cuda` (the three uniform streams),
the doc-row search (each token's total mass and both draws' term-3
topics), :func:`cdf_draws_cuda` (each draw's branch, term-2 target and
code), kernel 7 once a draw on the targets, and :func:`cdf_remedy_cuda`
(each draw's topic, then the paper's §3.1 remedy). A draw's code is its
term-1 topic on branch 0, -1 on branch 1 (kernel 7's answer is the topic)
and ``-2 - z3`` on branch 2 (``z3`` its term-3 topic).

Each kernel is bit-equal to its plain version on the card
(``-fmad=false``, IEEE division; the source's note). The plain versions
are torch ops: ``core.keys.stream_uniforms`` for the uniforms, and
:func:`cdf_draws_plain` and :func:`cdf_remedy_plain` here. The
``kernels="off"`` route (``algorithms.zen_cdf.PLAIN_ROUTE``) runs the same
three.

While a trace asks for it (``count=True``), the remedy kernel adds the
tokens that take draw b to the profiled stretch's counter
:data:`REMEDY_SECOND`, one atomic a block; its output is the same either
way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.zen_sampler import (
    MASK32,
    check_cuda_args,
    check_ids,
)

# the profiled stretch's counter of tokens whose remedy takes draw b
REMEDY_SECOND = "zen_cdf.remedy_second"


def cdf_uniforms_cuda(seed: int, start, n: int, streams: int,
                      device) -> torch.Tensor:
    """Launch ``cdf_uniforms`` on the current stream; no sync. A tensor
    ``start`` must be (n,) contiguous int32 on ``device``."""
    from repro_torch.kernels._build import check_launch, library

    index = None
    if isinstance(start, torch.Tensor):
        check_cuda_args([("token_index", start)], [torch.int32])
        if start.shape != (n,) or start.device != torch.device(device):
            raise ValueError(f"token_index must be ({n},) on {device}, got "
                             f"{tuple(start.shape)} on {start.device}")
        index = start
    if not 0 <= n < 2**31 - 2**16 or streams < 0:
        raise ValueError(f"{n} tokens x {streams} streams exceed the "
                         f"kernel's int sizes")
    out = torch.empty((streams, n), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        check_launch("cdf_uniforms", library().cdf_uniforms(
            int(seed) & MASK32, 0 if index is not None else start & MASK32,
            None if index is None else index.data_ptr(), out.data_ptr(), n,
            streams, stream))
    return out


def cdf_draws_plain(word, total, u_a, u_b, m2_all, g_cdf, z_d):
    """Plain-torch version of ``cdf_draws_kernel``: (targets (2, T)
    float32, code (2, T) int32), as :func:`cdf_draws_cuda` documents."""
    check_ids(word, m2_all.shape[0], "word")
    k = g_cdf.shape[0]
    m1 = g_cdf[-1]
    m12 = m1 + m2_all[word.long()]
    t = word.shape[0]
    targets = torch.empty((2, t), dtype=torch.float32, device=word.device)
    code = torch.empty((2, t), dtype=torch.int32, device=word.device)
    for i, u01 in enumerate((u_a, u_b)):
        u = u01 * total
        branch = torch.where(u < m1, 0, torch.where(u < m12, 1, 2))
        z_g = torch.clamp_max(torch.searchsorted(g_cdf, u), k - 1)
        targets[i] = torch.where(branch == 1, torch.clamp_min(u - m1, 0.0),
                                 0.0)
        code[i] = torch.where(branch == 0, z_g, torch.where(
            branch == 1, -1, -2 - z_d[i].long()))
    return targets, code


def cdf_draws_cuda(word, total, u_a, u_b, m2_all, g_cdf, z_d):
    """Launch ``cdf_draws`` on the current stream; no sync. For token t and
    each draw i (uniform ``u_a`` or ``u_b``): ``u = u01·total[t]``,
    ``m1 = g_cdf[K - 1]``, ``m12 = m1 + m2_all[word[t]]``; branch 0 where
    ``u < m1``, else 1 where ``u < m12``, else 2; ``targets[i, t]`` is
    ``max(u - m1, 0)`` on branch 1, else 0 (what kernel 7 searches);
    ``code[i, t]`` is the lower bound of u in ``g_cdf`` clamped to K - 1
    on branch 0, -1 on branch 1 and ``-2 - z_d[i, t]`` on branch 2. A word
    out of range aborts the kernel, and the caller's next synchronize
    raises."""
    from repro_torch.kernels._build import check_launch, library

    i32, f32 = torch.int32, torch.float32
    check_cuda_args(
        [("word", word), ("total", total), ("u_a", u_a), ("u_b", u_b),
         ("m2_all", m2_all), ("g_cdf", g_cdf), ("z_d", z_d)],
        [i32, f32, f32, f32, f32, f32, i32])
    t, (k,), (w,) = word.shape[0], g_cdf.shape, m2_all.shape
    if k < 1 or z_d.shape != (2, t) or \
            any(x.shape != (t,) for x in (word, total, u_a, u_b)):
        raise ValueError(
            f"shape mismatch: word/total/u_a/u_b "
            f"{[tuple(x.shape) for x in (word, total, u_a, u_b)]}, z_d "
            f"{tuple(z_d.shape)}, g_cdf {tuple(g_cdf.shape)} (K >= 1)")
    if t >= 2**31 - 2**16 or w >= 2**31:
        raise ValueError(f"{t} tokens over {w} words exceed the kernel's "
                         f"int sizes")
    targets = torch.empty((2, t), dtype=f32, device=word.device)
    code = torch.empty((2, t), dtype=i32, device=word.device)
    stream = torch.cuda.current_stream(word.device).cuda_stream
    with torch.cuda.device(word.device):
        check_launch("cdf_draws", library().cdf_draws(
            word.data_ptr(), total.data_ptr(), u_a.data_ptr(),
            u_b.data_ptr(), m2_all.data_ptr(), g_cdf.data_ptr(),
            z_d.data_ptr(), targets.data_ptr(), code.data_ptr(), t, k, w,
            stream))
    return targets, code


def cdf_remedy_plain(code, z_wa, z_wb, z_old, word, doc, n_wk, n_kd, u_r):
    """Plain-torch version of ``cdf_remedy_kernel``: (the new topics (T,)
    int32, the tokens that take draw b (T,) bool), as
    :func:`cdf_remedy_cuda` documents."""
    k = n_wk.shape[1]
    check_ids(z_old, k, "z_old")
    check_ids(word, n_wk.shape[0], "word")
    check_ids(doc, n_kd.shape[0], "doc")

    def topic(c, z_w):
        return torch.clamp_max(torch.where(
            c >= 0, c, torch.where(c == -1, z_w, -2 - c)), k - 1)

    z1, z2 = topic(code[0], z_wa), topic(code[1], z_wb)
    w, d, zo = word.long(), doc.long(), z_old.long()
    nw_prev = torch.clamp_min(n_wk[w, zo].to(torch.float32), 1.0)
    nd_prev = torch.clamp_min(n_kd[d, zo].to(torch.float32), 1.0)
    p_w = 1.0 / nw_prev
    p_d = torch.clamp(1.0 / nd_prev + (nd_prev + nw_prev - 1.0)
                      / (nd_prev * nw_prev), 0.0, 1.0)
    remedy_p = torch.where(code[0] == -1, p_w,
                           torch.where(code[0] < -1, p_d, 0.0))
    take_second = (z1 == z_old) & (u_r < remedy_p)
    return torch.where(take_second, z2, z1), take_second


def cdf_remedy_cuda(code, z_wa, z_wb, z_old, word, doc, n_wk, n_kd, u_r,
                    count: bool = False):
    """Launch ``cdf_remedy`` on the current stream; no sync. Draw i's topic
    is ``min(z, K - 1)`` with z its code where the code is >= 0, kernel
    7's answer (``z_wa``, ``z_wb``) where it is -1, and ``-2 - code``
    below; with z1 and z2 the two draws' topics, the token takes z2 where
    ``z1 == z_old[t]`` and ``u_r[t] < p``: p is ``1/nw`` where draw a took
    term 2, ``clamp(1/nd + (nd + nw - 1)/(nd·nw), 0, 1)`` where it took
    term 3 (nw = max(n_wk[word[t], z_old[t]], 1), nd the same of
    ``n_kd[doc[t]]``) and 0 on term 1. (T,) int32 out. ``count`` (only
    while tracing) adds the tokens that take z2 to :data:`REMEDY_SECOND`.
    An id out of range aborts the kernel, and the caller's next
    synchronize raises."""
    from repro_torch.kernels._build import (check_launch, library,
                                            work_counter)

    i32 = torch.int32
    check_cuda_args(
        [("code", code), ("z_wa", z_wa), ("z_wb", z_wb), ("z_old", z_old),
         ("word", word), ("doc", doc), ("n_wk", n_wk), ("n_kd", n_kd),
         ("u_r", u_r)],
        [i32, i32, i32, i32, i32, i32, i32, i32, torch.float32])
    t, (w, k), (d, kd) = z_old.shape[0], n_wk.shape, n_kd.shape
    if k < 1 or kd != k or code.shape != (2, t) or \
            any(x.shape != (t,) for x in (z_wa, z_wb, word, doc, u_r)):
        raise ValueError(
            f"shape mismatch: code {tuple(code.shape)}, z_old "
            f"{tuple(z_old.shape)}, z_wa/z_wb/word/doc/u_r "
            f"{[tuple(x.shape) for x in (z_wa, z_wb, word, doc, u_r)]}, "
            f"n_wk {tuple(n_wk.shape)}, n_kd {tuple(n_kd.shape)} (K >= 1)")
    if t >= 2**31 - 2**16 or max(w, d, k) >= 2**31:
        raise ValueError(f"{t} tokens, rows of {w} and {d} x {k} exceed "
                         f"the kernel's int sizes")
    out = torch.empty(t, dtype=i32, device=z_old.device)
    second = (work_counter("cdf_remedy_second", REMEDY_SECOND,
                           z_old.device) if count and t > 0 else None)
    stream = torch.cuda.current_stream(z_old.device).cuda_stream
    with torch.cuda.device(z_old.device):
        check_launch("cdf_remedy", library().cdf_remedy(
            code.data_ptr(), z_wa.data_ptr(), z_wb.data_ptr(),
            z_old.data_ptr(), word.data_ptr(), doc.data_ptr(),
            n_wk.data_ptr(), n_kd.data_ptr(), u_r.data_ptr(),
            out.data_ptr(), t, k, w, d, second, stream))
    return out
