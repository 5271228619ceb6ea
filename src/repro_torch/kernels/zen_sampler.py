"""Counter-based hash noise and the two gathered-row Gumbel-max samplers.

The hash is the Murmur3-style finalizer of the JAX package's
``kernels/zen_sampler.py``: Gumbel noise for (seed, row, col) is computed,
never stored, so the CUDA kernel, its plain version and the reference all
draw from the same coordinates. torch on the CPU cannot shift ``uint32``,
so every hash value here is an ``int64`` tensor holding a uint32 and masked
with ``0xFFFFFFFF`` after each multiply: int64 products wrap, and their low
32 bits are exact.

Serving: ``zen_infer_sample_cuda`` launches the hand-written Hopper kernel
(``csrc/zen_infer.cu``, ``zen_infer_gathered``) on pre-gathered (T, K)
rows; ``zen_infer_sample_plain`` is the same function in plain torch.
Training: ``zen_sample_cuda`` launches ``zen_train_gathered``
(``csrc/zen_train.cu``) and ``zen_sample_plain`` is its plain version.
The public dispatching wrappers are in ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import ctypes

import torch

MASK32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLD = 0x9E3779B9

# tokens per chunk of the plain versions: bounds the (chunk, K) float
# temporaries without changing any draw (every token is independent)
PLAIN_CHUNK = 4096


def u32(x) -> torch.Tensor:
    """Any integer tensor (or int) as int64 holding its uint32 bit pattern."""
    x = torch.as_tensor(x)
    return x.to(torch.int64) & MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = ((x ^ (x >> 16)) * _M1) & MASK32
    x = ((x ^ (x >> 13)) * _M2) & MASK32
    return x ^ (x >> 16)


def hash_bits(seed, row, col) -> torch.Tensor:
    """The 32-bit hash of (seed, row, col), broadcast, as int64."""
    return _mix(u32(seed) ^ ((u32(row) * _GOLD) & MASK32) ^ _mix(u32(col)))


def hash_uniform(seed, row, col) -> torch.Tensor:
    """Counter-based U(0, 1] in float32 from 24 hash bits (the top value
    rounds to exactly 1.0, as in the reference)."""
    h = hash_bits(seed, row, col)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


def gumbel_noise(seed, row, col) -> torch.Tensor:
    """Gumbel(0, 1) noise; +inf where the uniform rounds to 1.0."""
    return -torch.log(-torch.log(hash_uniform(seed, row, col)))


def mix32(x) -> torch.Tensor:
    """The avalanche mixer on uint32 values (int64 in, int64 out)."""
    return _mix(u32(x))


def golden_seed(key_bits_hi, key_bits_lo, pos) -> torch.Tensor:
    """Per-token int32 seeds ``mix(hi ^ mix(lo) ^ pos * GOLDEN)`` with the
    high bit cleared. Broadcasts: ``(B, 1)`` key words and ``(1, L)``
    positions give the ``(B, L)`` serving seed grid."""
    h = mix32(u32(key_bits_hi) ^ mix32(key_bits_lo)
              ^ ((u32(pos) * _GOLD) & MASK32))
    return (h & 0x7FFFFFFF).to(torch.int32)


def infer_argmax_rows(nwk_rows, nkd_rows, z_old, seeds, alpha_k, denom,
                      beta: float) -> torch.Tensor:
    """One chunk of the frozen-model Gumbel-max draw on gathered rows:
    ``argmax_k log max(p, 1e-30) + g(seed[t], 0, k)`` with
    ``p = (N_kd^¬t + α_k)(N_wk + β) / denom``; first maximal index wins."""
    k = nwk_rows.shape[1]
    cols = torch.arange(k, device=nwk_rows.device)
    self_hit = (cols[None, :] == z_old[:, None]).to(torch.float32)
    nw = nwk_rows.to(torch.float32)
    nd = nkd_rows.to(torch.float32) - self_hit
    p = (nd + alpha_k[None, :]) * (nw + beta) / denom[None, :]
    g = gumbel_noise(seeds[:, None], 0, cols[None, :])
    score = torch.log(torch.clamp_min(p, 1e-30)) + g
    return torch.argmax(score, dim=1).to(torch.int32)


def zen_infer_sample_plain(nwk_rows, nkd_rows, z_old, seeds, alpha_k, n_k,
                           *, beta: float, w_beta: float) -> torch.Tensor:
    """Plain-torch version of the gathered-row serving kernel."""
    alpha = alpha_k.to(torch.float32)
    denom = n_k.to(torch.float32) + w_beta
    out = torch.empty(nwk_rows.shape[0], dtype=torch.int32,
                      device=nwk_rows.device)
    for s in range(0, nwk_rows.shape[0], PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        out[s:e] = infer_argmax_rows(
            nwk_rows[s:e], nkd_rows[s:e], z_old[s:e], seeds[s:e],
            alpha, denom, beta,
        )
    return out


def train_argmax_rows(nwk_rows, nkd_rows, z_old, rows, seed: int, alpha_k,
                      n_k, beta: float, w_beta: float) -> torch.Tensor:
    """One chunk of the training Gumbel-max draw on gathered rows:
    ``argmax_k log max(p, 1e-30) + g(seed, rows[t], k)`` with exact ¬dw
    exclusion on all three counts and
    ``p = (α_k·β + N_wk·α_k + N_kd·(N_wk+β)) / (N_k + Wβ)``, in the
    reference kernel's op order; the first maximal index wins."""
    k = nwk_rows.shape[1]
    cols = torch.arange(k, device=nwk_rows.device)
    self_hit = (cols[None, :] == z_old[:, None]).to(torch.float32)
    nw = nwk_rows.to(torch.float32) - self_hit
    nd = nkd_rows.to(torch.float32) - self_hit
    nk = n_k[None, :] - self_hit
    a = alpha_k[None, :]
    p = (a * beta + nw * a + nd * (nw + beta)) / (nk + w_beta)
    g = gumbel_noise(seed, rows[:, None], cols[None, :])
    score = torch.log(torch.clamp_min(p, 1e-30)) + g
    return torch.argmax(score, dim=1).to(torch.int32)


def noise_rows(s: int, e: int, row_offset: int, token_index,
               device) -> torch.Tensor:
    """The noise rows of tokens [s, e) of a training launch:
    ``token_index[s:e]`` where given, else ``row_offset + t``."""
    if token_index is not None:
        return token_index[s:e].to(torch.int64)
    return torch.arange(row_offset + s, row_offset + e, device=device)


def zen_sample_plain(nwk_rows, nkd_rows, z_old, alpha_k, n_k, seed: int, *,
                     beta: float, w_beta: float, row_offset: int = 0,
                     token_index=None) -> torch.Tensor:
    """Plain-torch version of the gathered-row training kernel; token t's
    noise row is ``token_index[t]`` where given, else ``row_offset + t``."""
    alpha = alpha_k.to(torch.float32)
    nk = n_k.to(torch.float32)
    t = nwk_rows.shape[0]
    out = torch.empty(t, dtype=torch.int32, device=nwk_rows.device)
    for s in range(0, t, PLAIN_CHUNK):
        e = min(s + PLAIN_CHUNK, t)
        rows = noise_rows(s, e, row_offset, token_index, nwk_rows.device)
        out[s:e] = train_argmax_rows(
            nwk_rows[s:e], nkd_rows[s:e], z_old[s:e], rows, seed, alpha, nk,
            beta, w_beta,
        )
    return out


def check_seed(seed: int, row_offset: int, num_tokens: int,
               token_index=None) -> None:
    """The kernels take a non-negative int31 seed and int31 noise rows;
    a ``token_index`` is a contiguous int32 vector of ``num_tokens`` on
    the kernel's device (its values are the caller's: any int32)."""
    if not 0 <= int(seed) < 2**31:
        raise ValueError(f"seed {seed} is not a non-negative int31")
    if token_index is not None:
        if token_index.dtype != torch.int32 or \
                token_index.shape != (num_tokens,) or \
                not token_index.is_contiguous():
            raise ValueError(f"token_index must be {num_tokens} contiguous "
                             f"int32, got {token_index.dtype} "
                             f"{tuple(token_index.shape)}")
        return
    if row_offset < 0 or row_offset + num_tokens > 2**31:
        raise ValueError(f"noise rows [{row_offset}, "
                         f"{row_offset + num_tokens}) exceed int31")


def check_ids(ids: torch.Tensor, bound: int, name: str = "rows") -> None:
    """Raise unless every id lies in ``[0, bound)``: a plain version's
    indexing would wrap a negative id silently (the kernels trap)."""
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= bound):
        raise IndexError(f"{name} outside [0, {bound})")


def check_cuda_args(named, dtypes) -> None:
    """Raise unless every tensor lies on one CUDA device, is contiguous and
    has the dtype the kernel reads."""
    dev = None
    for (name, t), dt in zip(named, dtypes):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        dev = t.device
        if t.dtype != dt:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def zen_infer_sample_cuda(nwk_rows, nkd_rows, z_old, seeds, alpha_k, n_k,
                          *, beta: float, w_beta: float,
                          stats=None) -> torch.Tensor:
    """Launch ``zen_infer_gathered`` on the current stream; no sync.
    ``stats``: see :func:`infer_launch_extras`."""
    from repro_torch.kernels._build import check_launch, library

    i32, f32 = torch.int32, torch.float32
    check_cuda_args(
        [("nwk_rows", nwk_rows), ("nkd_rows", nkd_rows), ("z_old", z_old),
         ("seeds", seeds), ("alpha_k", alpha_k), ("n_k", n_k)],
        [i32, i32, i32, i32, f32, f32],
    )
    t, k = nwk_rows.shape
    if nkd_rows.shape != (t, k) or z_old.shape != (t,) \
            or seeds.shape != (t,) or alpha_k.shape != (k,) \
            or n_k.shape != (k,):
        raise ValueError(
            f"shape mismatch: rows {tuple(nwk_rows.shape)}/"
            f"{tuple(nkd_rows.shape)}, z_old {tuple(z_old.shape)}, "
            f"seeds {tuple(seeds.shape)}, alpha_k {tuple(alpha_k.shape)}, "
            f"n_k {tuple(n_k.shape)}"
        )
    out = torch.empty(t, dtype=i32, device=nwk_rows.device)
    scratch, extras = infer_launch_extras(k, nwk_rows.device, stats)
    stream = torch.cuda.current_stream(nwk_rows.device).cuda_stream
    with torch.cuda.device(nwk_rows.device):
        check_launch("zen_infer_gathered", library().zen_infer_gathered(
            nwk_rows.data_ptr(), nkd_rows.data_ptr(), z_old.data_ptr(),
            seeds.data_ptr(), alpha_k.data_ptr(), n_k.data_ptr(),
            out.data_ptr(), t, k, ctypes.c_float(beta),
            ctypes.c_float(w_beta), *extras, stream,
        ))
    return out


def global_table_entries(k: int, device, query: str) -> int:
    """The float4 entries of global scratch a launch at ``k`` topics needs
    on ``device``, by the library's ``query`` (``zen_train_global_table``
    or ``zen_infer_global_table``): 0 where the kernel keeps its per-topic
    table in shared memory (wherever the table fits in what a block can
    opt into, K <= 14,464 on an H100)."""
    from repro_torch.kernels._build import library

    entries = ctypes.c_longlong()
    with torch.cuda.device(device):
        err = getattr(library(), query)(int(k), ctypes.addressof(entries))
    if err:
        raise RuntimeError(f"{query}: cudaError {err}")
    return entries.value


def train_global_table_entries(k: int, device) -> int:
    """:func:`global_table_entries` of the training kernels."""
    return global_table_entries(k, device, "zen_train_global_table")


def infer_global_table_entries(k: int, device) -> int:
    """:func:`global_table_entries` of the serving kernels."""
    return global_table_entries(k, device, "zen_infer_global_table")


def launch_extras(k: int, device, stats, table_entries):
    """The verified samplers' trailing launch arguments, after the scratch
    the caller keeps until the launch: the global table's scratch of
    ``table_entries(k, device)`` float4 (None where the table goes in
    shared memory) and the optional stats pointer (an int64 CUDA tensor of
    3 that accumulates the topics scored exactly in the pass or as z_old,
    the rescored candidates and the tokens sampled by the exact loop; for
    tests and measurements: the paths pass none). ``stats`` is checked
    before the library is asked anything."""
    if stats is not None:
        check_cuda_args([("stats", stats)], [torch.int64])
        if stats.shape != (3,) or stats.device != torch.device(device):
            raise ValueError("stats must be 3 int64 on the kernel's device")
    entries = table_entries(k, device)
    scratch = (torch.empty((entries, 4), dtype=torch.float32, device=device)
               if entries else None)
    return scratch, (None if scratch is None else scratch.data_ptr(),
                     None if stats is None else stats.data_ptr())


def train_launch_extras(k: int, device, stats):
    """:func:`launch_extras` of the training kernels."""
    return launch_extras(k, device, stats, train_global_table_entries)


def infer_launch_extras(k: int, device, stats):
    """:func:`launch_extras` of the serving kernels."""
    return launch_extras(k, device, stats, infer_global_table_entries)


def fast_score_errors(device, kernels: str = "train") -> dict:
    """A verified sampler's margin premises, measured by exhaustion on the
    card with the kernel's own estimate functions (test-only launch;
    ``kernels``: "train" for ``zen_train.cu``, "infer" for
    ``zen_infer.cu``): ``noise_err`` (2^24 float64, one per m) and
    ``log_err``, the largest |ln2 lg2(x) - logf(x)| over every float x in
    [1e-30, FLT_MAX]."""
    from repro_torch.kernels._build import check_launch, library

    if kernels not in ("train", "infer"):
        raise ValueError(f"kernels must be 'train' or 'infer', not "
                         f"{kernels!r}")
    lib = library()
    margin, top = ctypes.c_float(), ctypes.c_int()
    getattr(lib, f"zen_{kernels}_constants")(ctypes.addressof(margin),
                                             ctypes.addressof(top))
    noise = torch.empty(1 << 24, dtype=torch.float64, device=device)
    worst = torch.zeros(1, dtype=torch.int64, device=device)
    lo = int(torch.tensor(1e-30, dtype=torch.float32).view(torch.int32))
    stream = torch.cuda.current_stream(device).cuda_stream
    name = f"zen_{kernels}_fast_error"
    with torch.cuda.device(device):
        check_launch(name, getattr(lib, name)(
            noise.data_ptr(), lo, 0x7F7FFFFF, worst.data_ptr(), stream))
    torch.cuda.synchronize(device)
    return {"margin": margin.value, "top_bucket": top.value,
            "noise_err": noise,
            "log_err": float(worst.cpu().view(torch.float64)[0])}


def zen_sample_cuda(nwk_rows, nkd_rows, z_old, alpha_k, n_k, seed: int, *,
                    beta: float, w_beta: float, row_offset: int = 0,
                    token_index=None, stats=None) -> torch.Tensor:
    """Launch ``zen_train_gathered`` on the current stream; no sync.
    ``token_index``: (T,) int32 noise rows on the card, else
    ``row_offset + t``. ``stats``: see :func:`train_launch_extras`."""
    from repro_torch.kernels._build import check_launch, library

    i32, f32 = torch.int32, torch.float32
    check_cuda_args(
        [("nwk_rows", nwk_rows), ("nkd_rows", nkd_rows), ("z_old", z_old),
         ("alpha_k", alpha_k), ("n_k", n_k)],
        [i32, i32, i32, f32, f32],
    )
    t, k = nwk_rows.shape
    if nkd_rows.shape != (t, k) or z_old.shape != (t,) \
            or alpha_k.shape != (k,) or n_k.shape != (k,):
        raise ValueError(
            f"shape mismatch: rows {tuple(nwk_rows.shape)}/"
            f"{tuple(nkd_rows.shape)}, z_old {tuple(z_old.shape)}, "
            f"alpha_k {tuple(alpha_k.shape)}, n_k {tuple(n_k.shape)}"
        )
    check_seed(seed, row_offset, t, token_index)
    if token_index is not None:
        check_cuda_args([("token_index", token_index)], [i32])
    out = torch.empty(t, dtype=i32, device=nwk_rows.device)
    scratch, extras = train_launch_extras(k, nwk_rows.device, stats)
    stream = torch.cuda.current_stream(nwk_rows.device).cuda_stream
    with torch.cuda.device(nwk_rows.device):
        check_launch("zen_train_gathered", library().zen_train_gathered(
            nwk_rows.data_ptr(), nkd_rows.data_ptr(), z_old.data_ptr(),
            alpha_k.data_ptr(), n_k.data_ptr(), out.data_ptr(), t, k,
            int(seed), int(row_offset),
            None if token_index is None else token_index.data_ptr(),
            ctypes.c_float(beta),
            ctypes.c_float(w_beta), *extras, stream,
        ))
    return out
