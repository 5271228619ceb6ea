"""Alias tables (Walker/Vose), the paper's O(1) samplers for gDense and
wSparse (``repro/core/alias.py``).

* ``build_alias`` — the reference's fixed-iteration stack-based Vose, in
  float32 and its op order. The reference ``vmap``s it over W word rows;
  here the row dimension is written out: ``p`` is (K,) or (R, K), and all
  R tables are built in one loop of at most 2K steps. The loop stops early
  once no row can move (every later step of the reference is a no-op).
* ``build_alias_counts`` / ``sample_alias_counts`` — the host-side (numpy)
  integer-exact construction for count vectors (paper §5.3), a copy.
* ``FPlusTree`` — the F+ tree of Table 1 for terms that change per sample.

Sums are float32: ``torch.sum`` and XLA's reductions add in different
orders, so a table built from a non-integer pmf may differ from the
reference's in the last bits; on integer pmfs the two are equal.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

# steps between the host checks for "no row can move" in build_alias
_CHECK_EVERY = 32


class AliasTable(NamedTuple):
    prob: torch.Tensor  # (..., K) float32: threshold for keeping the bin
    alias: torch.Tensor  # (..., K) int32: alternative outcome of each bin


def build_alias(p: torch.Tensor) -> AliasTable:
    """Vose alias construction of the unnormalised pmf ``p`` (K,) or
    (R, K), each row its own table; an all-zero row gives the uniform."""
    rows = p.reshape(-1, p.shape[-1]).to(torch.float32)
    r, k = rows.shape
    dev = rows.device
    total = torch.sum(rows, dim=-1, keepdim=True)
    # a true division: ``k / tensor`` would multiply by a rounded reciprocal
    scale = torch.tensor(float(k), device=dev) / torch.clamp_min(total,
                                                                 1e-30)
    q = torch.where(total > 0, rows * scale, torch.ones((), device=dev))
    idx = torch.arange(k, device=dev).expand(r, k)
    small0 = q < 1.0
    # stable partition of the indices into the two stacks
    order_small = torch.argsort(torch.where(small0, idx, k), dim=-1,
                                stable=True)
    order_large = torch.argsort(torch.where(~small0, idx, k), dim=-1,
                                stable=True)
    st = small0.sum(-1)
    lt = k - st
    # stacks preallocated to 2K: every large can be demoted to small once
    pad = torch.zeros((r, k), dtype=torch.int64, device=dev)
    ss = torch.cat([order_small, pad], dim=-1)
    ls = torch.cat([order_large, pad], dim=-1)
    prob = torch.ones((r, k), dtype=torch.float32, device=dev)
    alias = idx.clone()

    def at(m, i):
        return m.gather(1, i[:, None])[:, 0]

    def put(m, i, v):
        m.scatter_(1, i[:, None], v[:, None])

    for step in range(2 * k):
        can = (st > 0) & (lt > 0)
        if step % _CHECK_EVERY == 0 and not bool(can.any()):
            break
        si = torch.clamp_min(st - 1, 0)
        s = at(ss, si)
        l = at(ls, torch.clamp_min(lt - 1, 0))
        q_s, q_l = at(q, s), at(q, l)
        put(prob, s, torch.where(can, q_s, at(prob, s)))
        put(alias, s, torch.where(can, l, at(alias, s)))
        ql = q_l - (1.0 - q_s)
        put(q, l, torch.where(can, ql, q_l))
        l_small = ql < 1.0
        # pop s; a demoted l replaces s on the small stack, otherwise l
        # stays on top of the large stack
        put(ss, si, torch.where(can & l_small, l, s))
        st = torch.where(can & ~l_small, st - 1, st)
        lt = torch.where(can & l_small, lt - 1, lt)
    shape = p.shape
    return AliasTable(prob=prob.reshape(shape),
                      alias=alias.to(torch.int32).reshape(shape))


def sample_alias(table: AliasTable, u_bin: torch.Tensor,
                 u_split: torch.Tensor) -> torch.Tensor:
    """O(1) draws from a (K,) table: pick a bin with ``u_bin``, resolve its
    split with ``u_split`` (uniforms in [0, 1) of one shape)."""
    k = table.prob.shape[-1]
    bins = torch.clamp_max((u_bin * k).to(torch.int64), k - 1)
    keep = u_split < table.prob[bins]
    return torch.where(keep, bins, table.alias[bins].to(torch.int64))


def sample_alias_reuse(table: AliasTable, u: torch.Tensor) -> torch.Tensor:
    """One uniform for both: its fractional part resolves the split."""
    k = table.prob.shape[-1]
    scaled = u * k
    bins = torch.clamp_max(scaled.to(torch.int64), k - 1)
    frac = scaled - bins.to(scaled.dtype)
    keep = frac < table.prob[bins]
    return torch.where(keep, bins, table.alias[bins].to(torch.int64))


def alias_pmf(table: AliasTable) -> torch.Tensor:
    """The exact pmf a (K,) or (R, K) table realises."""
    k = table.prob.shape[-1]
    direct = table.prob / k
    spill = torch.zeros_like(direct).scatter_add_(
        -1, table.alias.to(torch.int64), (1.0 - table.prob) / k)
    return direct + spill


def build_alias_counts(counts: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host-side integer-exact alias build for count vectors (§5.3): every
    count scaled by K so that bin masses and thresholds stay integral; only
    the above-average worklist is kept. Bin i keeps itself when
    ``u_int < prob_num[i]`` with ``u_int`` uniform over [0, total).
    Returns (prob_num int64 (K,), alias int32 (K,), total)."""
    counts = np.asarray(counts, dtype=np.int64)
    k = counts.shape[0]
    total = int(counts.sum())
    if total == 0:
        return np.full(k, 1, np.int64), np.arange(k, dtype=np.int32), 1
    q = counts * k  # scaled masses; average bin mass == total
    prob_num = np.full(k, total, dtype=np.int64)
    alias = np.arange(k, dtype=np.int32)
    high = [i for i in range(k) if q[i] > total]
    low = [i for i in range(k) if q[i] < total]
    while low and high:
        s = low.pop()
        l = high[-1]
        prob_num[s] = q[s]
        alias[s] = l
        q[l] -= total - q[s]
        if q[l] <= total:
            high.pop()
            if q[l] < total:
                low.append(l)
    return prob_num, alias, total


def sample_alias_counts(prob_num: np.ndarray, alias: np.ndarray, total: int,
                        rng: np.random.Generator, n: int) -> np.ndarray:
    """Host-side draws from an integer alias table."""
    k = prob_num.shape[0]
    bins = rng.integers(0, k, size=n)
    u = rng.integers(0, total, size=n)
    return np.where(u < prob_num[bins], bins, alias[bins]).astype(np.int32)


class FPlusTree(NamedTuple):
    """F+ tree: a complete binary tree over topic masses, ``tree`` (2 cap,)
    float32 with the leaves at [cap, cap + K), cap = next_pow2(K)."""

    tree: torch.Tensor
    k: int


def ftree_build(p: torch.Tensor) -> FPlusTree:
    k = p.shape[0]
    cap = 1 << max(1, (k - 1).bit_length())
    tree = torch.zeros(2 * cap, dtype=torch.float32, device=p.device)
    tree[cap:cap + k] = p.to(torch.float32)
    size = cap // 2
    while size >= 1:
        i = torch.arange(size, 2 * size, device=p.device)
        tree[i] = tree[2 * i] + tree[2 * i + 1]
        size //= 2
    return FPlusTree(tree=tree, k=k)


def ftree_total(t: FPlusTree) -> torch.Tensor:
    return t.tree[1]


def ftree_sample(t: FPlusTree, u: torch.Tensor) -> torch.Tensor:
    """Descend with target mass ``u * total``; vectorised over ``u``."""
    cap = t.tree.shape[0] // 2
    target = u * t.tree[1]
    node = torch.ones(u.shape, dtype=torch.int64, device=u.device)
    for _ in range(int(np.log2(cap))):
        left = t.tree[2 * node]
        go_right = target >= left
        node = 2 * node + go_right.to(torch.int64)
        target = torch.where(go_right, target - left, target)
    return torch.clamp_max(node - cap, t.k - 1).to(torch.int32)


def ftree_update(t: FPlusTree, index: int,
                 new_value: float) -> FPlusTree:
    """Leaf ``index`` set to ``new_value``, ancestors fixed (O(log K))."""
    cap = t.tree.shape[0] // 2
    node = int(index) + cap
    tree = t.tree.clone()
    delta = torch.as_tensor(new_value, dtype=torch.float32,
                            device=tree.device) - tree[node]
    for _ in range(int(np.log2(cap)) + 1):
        tree[node] += delta
        node //= 2
    return FPlusTree(tree=tree, k=t.k)
