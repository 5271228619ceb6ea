"""Corpus-graph partitioning (``repro/core/graph.py``, paper §4.1): the
data/model co-partitioner, in host numpy as in the reference, and
bit-equal to it.

The corpus is the bipartite word-doc graph; distribution = partitioning it.

Vertex-cut strategies (the paper's GraphX menu and its contribution):
  * random_vertex_cut  — hash(src, dst)
  * edge_partition_1d  — hash(word) (co-locates a word's edges)
  * edge_partition_2d  — "rectangle" grid partition, the 2*sqrt(P)
                          replication bound
  * dbh                — degree-based hashing [Xie et al.]: cut the
                          higher-degree endpoint
  * dbh_plus           — paper Alg. 3: like DBH, but when BOTH degrees are
                          below a threshold, co-locate with the *higher*-
                          degree endpoint instead

``grid_partition`` is the mesh plan's physical layout: it relabels words
and docs so each mesh column owns a contiguous, token-balanced word range
(greedy LPT bin-packing, hot words spread first) and each mesh row a
contiguous doc range, then pads every cell to one edge count. Beyond the
reference's arrays, :class:`GridPartition` carries ``token``: the corpus
index of each slot, which a cell's draws hash (``core.keys``), so a mesh
draws what the single box draws.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.types import Corpus  # noqa: F401  (type of the input)


def _host(x) -> np.ndarray:
    """A host numpy view of a torch tensor or array."""
    if hasattr(x, "cpu"):
        return x.cpu().numpy()
    return np.asarray(x)



# ---------------------------------------------------------------------------
# Classic vertex-cut partitioners (edge -> partition id)
# ---------------------------------------------------------------------------

def _hash(x: np.ndarray, seed: int = 0x9E3779B9) -> np.ndarray:
    x = x.astype(np.uint64)
    x = (x ^ (x >> 16)) * np.uint64(0x45D9F3B + seed)
    x = (x ^ (x >> 13)) * np.uint64(0xC2B2AE35)
    return x ^ (x >> 16)


def random_vertex_cut(word: np.ndarray, doc: np.ndarray, p: int) -> np.ndarray:
    return ((_hash(word) ^ _hash(doc, 17)) % p).astype(np.int32)


def edge_partition_1d(word: np.ndarray, doc: np.ndarray, p: int) -> np.ndarray:
    return (_hash(word) % p).astype(np.int32)


def edge_partition_2d(word: np.ndarray, doc: np.ndarray, p: int) -> np.ndarray:
    rows = int(np.floor(np.sqrt(p)))
    while p % rows:
        rows -= 1
    cols = p // rows
    return ((_hash(doc) % rows) * cols + (_hash(word, 5) % cols)).astype(np.int32)


def dbh(word: np.ndarray, doc: np.ndarray, p: int) -> np.ndarray:
    """Degree-based hashing: assign the edge by hashing its lower-degree
    endpoint (i.e. the higher-degree vertex gets cut/replicated)."""
    w_deg = np.bincount(word, minlength=word.max() + 1)[word]
    d_deg = np.bincount(doc, minlength=doc.max() + 1)[doc]
    use_word = w_deg <= d_deg
    return np.where(
        use_word, _hash(word) % p, (_hash(doc, 17) % p)
    ).astype(np.int32)


def dbh_plus(
    word: np.ndarray, doc: np.ndarray, p: int, threshold: int = 8
) -> np.ndarray:
    """Paper Alg. 3 (DBH+): DBH, except when max(deg_w, deg_d) < threshold
    the edge follows the *higher*-degree endpoint — for cold edges locality
    (fewer replicas) matters more than cutting the bigger vertex."""
    w_deg = np.bincount(word, minlength=word.max() + 1)[word]
    d_deg = np.bincount(doc, minlength=doc.max() + 1)[doc]
    both_cold = np.maximum(w_deg, d_deg) < threshold
    # hot edges: hash lower-degree endpoint (cut the hub)
    use_word_hot = w_deg <= d_deg
    # cold edges: hash HIGHER-degree endpoint (keep the small star together)
    use_word_cold = w_deg >= d_deg
    use_word = np.where(both_cold, use_word_cold, use_word_hot)
    return np.where(
        use_word, _hash(word) % p, (_hash(doc, 17) % p)
    ).astype(np.int32)


PARTITIONERS = {
    "random_vertex_cut": random_vertex_cut,
    "edge_partition_1d": edge_partition_1d,
    "edge_partition_2d": edge_partition_2d,
    "dbh": dbh,
    "dbh_plus": dbh_plus,
}


def partition_metrics(
    word: np.ndarray, doc: np.ndarray, part: np.ndarray, p: int
) -> Dict[str, float]:
    """Balance + replication metrics (PowerGraph's cost model, paper §4.1):
    workload ∝ edges per partition; comms ∝ total vertex mirrors."""
    edges_per = np.bincount(part, minlength=p)
    # replication factor: how many partitions each vertex appears in
    wp = np.unique(np.stack([word, part]), axis=1).shape[1]
    dp = np.unique(np.stack([doc, part]), axis=1).shape[1]
    n_w = np.unique(word).size
    n_d = np.unique(doc).size
    return {
        "edge_balance": float(edges_per.max() / max(edges_per.mean(), 1e-9)),
        "word_replication": float(wp / n_w),
        "doc_replication": float(dp / n_d),
        "total_replication": float((wp + dp) / (n_w + n_d)),
    }


# ---------------------------------------------------------------------------
# SPMD grid partition (the physical layout for the TPU mesh)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GridPartition:
    """Relabeled, padded 2D layout of a corpus for a (data x model) mesh.

    Arrays are global-view; axis 0 is `data*model` cells ordered row-major
    (cell = row * model + col). Each cell's real tokens come first, sorted
    by (word, doc) (``sort_tokens_by="word"``), then its padding.
    """

    word: np.ndarray  # (cells, e_cell) int32 — NEW (relabeled) word ids
    doc: np.ndarray  # (cells, e_cell) int32 — NEW doc ids
    mask: np.ndarray  # (cells, e_cell) bool — False on padding
    data_parallel: int
    model_parallel: int
    words_per_shard: int  # W_pad / model_parallel
    docs_per_shard: int  # D_pad / data_parallel
    word_perm: np.ndarray  # old -> new word id (W,)
    doc_perm: np.ndarray  # old -> new doc id (D,)
    # (cells, e_cell) int64: the corpus index of each slot, 0 on padding
    token: np.ndarray

    @property
    def num_words_padded(self) -> int:
        return self.words_per_shard * self.model_parallel

    @property
    def num_docs_padded(self) -> int:
        return self.docs_per_shard * self.data_parallel

    @property
    def padding_overhead(self) -> float:
        return float(self.mask.size / max(self.mask.sum(), 1)) - 1.0


def _balanced_ranges(loads: np.ndarray, bins: int) -> np.ndarray:
    """Greedy LPT bin-packing: assign items (sorted by descending load) to
    the least-loaded bin. Returns bin id per item. This is the DBH+ insight
    applied to static ranges: hot items get spread first."""
    order = np.argsort(-loads, kind="stable")
    bin_load = np.zeros(bins, dtype=np.int64)
    assign = np.zeros(loads.shape[0], dtype=np.int32)
    for it in order:
        b = int(np.argmin(bin_load))
        assign[it] = b
        bin_load[b] += int(loads[it])
    return assign


def _stable_lexsort(keys, sizes) -> np.ndarray:
    """``np.lexsort(keys)`` (last key primary) for non-negative int keys
    below ``sizes``, through their mixed-radix number: a stable LSD radix
    sort in 16-bit digits where it fits 32 bits, else one stable int64
    argsort (the same permutation either way, 1.5-3x faster at 10^8
    tokens), else ``np.lexsort``."""
    span = 1
    for n in sizes:
        span *= max(int(n), 1)
    if span >= 2**62:
        return np.lexsort(keys)
    combined = np.zeros(keys[0].shape, dtype=np.int64)
    for key, n in zip(reversed(keys), reversed(sizes)):
        combined *= max(int(n), 1)
        combined += key
    if span > 2**32:
        return np.argsort(combined, kind="stable")
    order, shift = None, 0
    while True:  # numpy sorts 16-bit keys stably by radix
        digits = combined if order is None else combined[order]
        step = np.argsort(((digits >> shift) & 0xFFFF).astype(np.uint16),
                          kind="stable")
        order = step if order is None else order[step]
        shift += 16
        if (span - 1) >> shift == 0:
            return order


def grid_partition(
    corpus,
    data_parallel: int,
    model_parallel: int,
    e_cell_multiple: int = 8,
    balance: str = "lpt",  # lpt | hash
    sort_tokens_by: str = "word",  # word-by-word process order (paper §3.1)
) -> GridPartition:
    word = _host(corpus.word)
    doc = _host(corpus.doc)
    w_tok = np.bincount(word, minlength=corpus.num_words)
    d_tok = np.bincount(doc, minlength=corpus.num_docs)

    if balance == "lpt":
        w_col = _balanced_ranges(w_tok, model_parallel)
        d_row = _balanced_ranges(d_tok, data_parallel)
    else:
        w_col = (_hash(np.arange(corpus.num_words)) % model_parallel).astype(np.int32)
        d_row = (_hash(np.arange(corpus.num_docs), 17) % data_parallel).astype(np.int32)

    # Relabel so each column's words are contiguous & uniform-width.
    def relabel(assign: np.ndarray, bins: int) -> Tuple[np.ndarray, int]:
        counts = np.bincount(assign, minlength=bins)
        per = int(counts.max())
        perm = np.empty(assign.shape[0], dtype=np.int64)
        for b in range(bins):
            ids = np.where(assign == b)[0]
            perm[ids] = b * per + np.arange(ids.size)
        return perm, per

    word_perm, words_per_shard = relabel(w_col, model_parallel)
    doc_perm, docs_per_shard = relabel(d_row, data_parallel)

    new_word = word_perm[word]
    new_doc = doc_perm[doc]
    row = (new_doc // docs_per_shard).astype(np.int64)
    col = (new_word // words_per_shard).astype(np.int64)
    cell = row * model_parallel + col
    cells = data_parallel * model_parallel

    cell_counts = np.bincount(cell, minlength=cells)
    e_cell = int(cell_counts.max())
    e_cell = ((e_cell + e_cell_multiple - 1) // e_cell_multiple) * e_cell_multiple
    e_cell = max(e_cell, e_cell_multiple)

    out_w = np.zeros((cells, e_cell), dtype=np.int32)
    out_d = np.zeros((cells, e_cell), dtype=np.int32)
    out_m = np.zeros((cells, e_cell), dtype=bool)
    out_t = np.zeros((cells, e_cell), dtype=np.int64)
    w_pad = words_per_shard * model_parallel
    d_pad = docs_per_shard * data_parallel
    if sort_tokens_by == "word":
        keys, sizes = (new_doc, new_word, cell), (d_pad, w_pad, cells)
        if doc.size < 2 or bool((doc[1:] >= doc[:-1]).all()):
            # a doc-major corpus: relabel keeps a row's docs in order, so
            # within a cell the docs already ascend and a stable sort by
            # (cell, word) alone orders them as the doc key would
            keys, sizes = keys[1:], sizes[1:]
    else:
        keys, sizes = (new_word, new_doc, cell), (w_pad, d_pad, cells)
    order = _stable_lexsort(keys, sizes)
    sw, sd, sc = new_word[order], new_doc[order], cell[order]
    starts = np.searchsorted(sc, np.arange(cells))
    ends = np.searchsorted(sc, np.arange(cells) + 1)
    for c in range(cells):
        n = ends[c] - starts[c]
        out_w[c, :n] = sw[starts[c] : ends[c]]
        out_d[c, :n] = sd[starts[c] : ends[c]]
        out_m[c, :n] = True
        out_t[c, :n] = order[starts[c] : ends[c]]
        # padding tokens point at the cell's own (word, doc) range so local
        # index arithmetic stays in-bounds; mask keeps them inert.
        r, cc = divmod(c, model_parallel)
        out_w[c, n:] = cc * words_per_shard
        out_d[c, n:] = r * docs_per_shard

    return GridPartition(
        word=out_w, doc=out_d, mask=out_m,
        data_parallel=data_parallel, model_parallel=model_parallel,
        words_per_shard=words_per_shard, docs_per_shard=docs_per_shard,
        word_perm=word_perm.astype(np.int64),
        doc_perm=doc_perm.astype(np.int64),
        token=out_t,
    )
