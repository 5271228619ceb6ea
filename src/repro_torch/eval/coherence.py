"""Topic coherence: UMass and sliding-window NPMI
(``repro/eval/coherence.py``), with the corpus statistics counted on the
corpus's device.

Both metrics score a topic by how often its top-N words co-occur in the
corpus (Mimno et al. 2011; Röder et al. 2015).

* UMass: document co-occurrence. For a topic's top words ordered by
  descending count ``v_1..v_N``::

      C_umass = sum_{m=2..N} sum_{l<m} log[(D(v_m, v_l) + 1) / D(v_l)]

  ``D(w)`` is the number of documents containing ``w``, ``D(w, w')`` the
  number containing both; a pair whose denominator word never occurs is
  skipped.
* NPMI: ``p(w)`` is the fraction of windows (length ``window``, stride 1;
  a document no longer than ``window`` is one window, an empty one has
  none) containing ``w``::

      npmi(w, w') = log[p(w, w') / (p(w) p(w'))] / (-log p(w, w'))

  averaged over unordered top-word pairs; a never-co-occurring pair gives
  -1, a pair in every window 1.

The reference builds one Python set per document and per window; at
NYTIMES size (~10^8 tokens, ~10^8 windows) that is tens of GB of host
objects. Here every statistic is an exact integer counted with tensor
operations on the corpus's device, and only the counts of the words and
pairs one top-word matrix needs cross to the host:

* per token, its position in its document and the position of the
  previous occurrence of its word there (one stable sort by
  (document, word));
* ``D(w)``: the tokens with no previous occurrence, counted by word;
* window counts: a window holding ``w`` is counted once, at the first
  occurrence of ``w`` in it, so a token at position ``p`` with previous
  occurrence ``r`` counts the window starts
  ``[max(r + 1, p - window + 1, 0), min(p, last_start)]``;
* pair window counts: likewise at the pair of first occurrences, so the
  position pairs ``p < q`` with ``q - p < window`` (``window - 1`` passes
  over the tokens) count the starts
  ``[max(r_p + 1, r_q + 1, q - window + 1, 0), min(p, last_start)]``,
  scatter-added into the needed pairs;
* ``D(w, w')``: a 0/1 membership matrix of documents by the distinct
  words asked about, multiplied by its transpose in int8 with int32 sums
  (``torch._int_mm``), a block of documents at a time.

The float formulas are then applied on the host, in the reference's pair
order and with its skips.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import as_device_tensor

# int8 membership blocks of at most this many bytes (documents x words)
_MEMBERSHIP_BYTES = 1 << 28
# top-word selection walks the topics in column blocks of this width
_TOPK_BLOCK = 256


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def top_topic_words(n_wk, top_n: int,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> torch.Tensor:
    """Top-``top_n`` word ids per topic, (K, top_n) int32 on ``n_wk``'s
    device (a numpy ``n_wk`` goes to ``device``: the card unless the
    caller asks for the CPU).

    Ordered by descending ``N_w|k``, ties to the lower word id, as the
    reference's stable argsort gives them: the selection runs on the
    tie-free int64 key ``count * W + (W - 1 - w)``."""
    n_wk = as_device_tensor(n_wk, device)
    w, k = int(n_wk.shape[0]), int(n_wk.shape[1])
    top_n = min(int(top_n), w)
    out = torch.empty((k, top_n), dtype=torch.int32, device=n_wk.device)
    if top_n <= 0 or k == 0:
        return out
    rev = (w - 1) - torch.arange(w, dtype=torch.int64, device=n_wk.device)
    for k0 in range(0, k, _TOPK_BLOCK):
        key = n_wk[:, k0:k0 + _TOPK_BLOCK].to(torch.int64) * w \
            + rev[:, None]
        idx = torch.topk(key, top_n, dim=0, largest=True, sorted=True).indices
        out[k0:k0 + _TOPK_BLOCK] = idx.t().to(torch.int32)
    return out


class _DocSequences(Sequence):
    """The corpus's per-document word sequences in edge order, as the
    reference's ``CoherenceStats.docs`` list holds them; each document is
    copied to the host when it is read."""

    def __init__(self, words: torch.Tensor, bounds: np.ndarray):
        self._words = words
        self._bounds = bounds

    def __len__(self) -> int:
        return len(self._bounds) - 1

    def __getitem__(self, d):
        if isinstance(d, slice):
            return [self[i] for i in range(*d.indices(len(self)))]
        d = range(len(self))[d]
        lo, hi = int(self._bounds[d]), int(self._bounds[d + 1])
        return self._words[lo:hi].cpu().numpy()

    def __iter__(self) -> Iterator[np.ndarray]:
        return (self[d] for d in range(len(self)))


class CoherenceStats:
    """Corpus co-occurrence statistics shared by both coherence metrics.

    Built once per corpus from its (E,) ``word`` and ``doc`` ids (tensors,
    counted on their device, or numpy arrays, counted on ``device``: the
    card unless the caller asks for the CPU); queried per
    eval with the words the current model's top-word matrix needs, as
    arrays of word ids (of pairs: two arrays). The per-word counts answer
    every word at once; the pair counts are counted for the pairs asked,
    in one batch. Words outside the corpus count 0.
    """

    def __init__(self, word, doc, num_docs: int, window: int = 10,
                 num_words=None,
                 device: Optional[Union[str, torch.device]] = None):
        word = as_device_tensor(word, device).to(torch.int32)
        doc = as_device_tensor(doc, word.device).to(torch.int32)
        dev = word.device
        self.device = dev
        self.num_docs = int(num_docs)
        self.window = max(1, int(window))
        e = int(word.shape[0])
        if num_words is None:
            num_words = int(word.max()) + 1 if e else 0
        self.num_words = int(num_words)
        # tokens grouped by document, edge order kept within a document
        if e and bool((doc[1:] < doc[:-1]).any()):
            order = torch.sort(doc, stable=True).indices
            word, doc = word[order], doc[order]
        bounds = torch.searchsorted(
            doc, torch.arange(self.num_docs + 1, dtype=torch.int32,
                              device=dev))
        starts = bounds[:-1]
        lengths = bounds[1:] - starts
        self.docs = _DocSequences(word, bounds.cpu().numpy())
        last_start = (lengths - self.window).clamp_(min=0)
        self.num_windows = int(((last_start + 1) * (lengths > 0)).sum())
        # per token: position in its document, its document's last window
        # start, and the position of the previous occurrence of its word
        # in that document (-1: none)
        pos = torch.arange(e, dtype=torch.int64, device=dev) \
            - starts.long()[doc.long()]
        key = doc.long() * max(1, self.num_words) + word.long()
        skey, perm = torch.sort(key, stable=True)
        prev = torch.full((e,), -1, dtype=torch.int64, device=dev)
        if e > 1:
            same = skey[1:] == skey[:-1]
            prev[perm[1:][same]] = pos[perm[:-1][same]]
        del key, skey, perm
        self._word = word
        self._doc = doc
        self._pos = pos.to(torch.int32)
        self._prev = prev.to(torch.int32)
        self._last = last_start.to(torch.int32)[doc.long()]
        first = prev < 0
        w_long = word.long()
        # D(w) and the window count of w, for every word of the vocabulary
        # (one int64 per word on the host)
        self._doc_freq_host = torch.zeros(
            self.num_words, dtype=torch.int64, device=dev).index_add_(
            0, w_long[first], torch.ones_like(w_long[first])).cpu().numpy()
        lo = torch.maximum(prev + 1, pos - self.window + 1).clamp_(min=0)
        hi = torch.minimum(pos, self._last.long())
        per_token = (hi - lo + 1).clamp_(min=0)
        self._win_count_host = torch.zeros(
            self.num_words, dtype=torch.int64, device=dev).index_add_(
            0, w_long, per_token).cpu().numpy()

    @classmethod
    def from_corpus(cls, corpus, window: int = 10) -> "CoherenceStats":
        """Build from a ``repro_torch.core.types.Corpus``, on its
        device."""
        return cls(corpus.word, corpus.doc, corpus.num_docs, window=window,
                   num_words=corpus.num_words)

    # -- per-word counts ----------------------------------------------------
    def _lookup(self, host_counts: np.ndarray, w) -> np.ndarray:
        w = _host(w).astype(np.int64).reshape(-1)
        ok = (w >= 0) & (w < self.num_words)
        out = np.zeros(w.shape, np.int64)
        out[ok] = host_counts[w[ok]]
        return out

    def doc_freq(self, w) -> np.ndarray:
        """D(w): documents containing each word."""
        return self._lookup(self._doc_freq_host, w)

    def window_count(self, w) -> np.ndarray:
        """Windows containing each word."""
        return self._lookup(self._win_count_host, w)

    def window_prob(self, w) -> np.ndarray:
        """Fraction of windows containing each word."""
        return self._prob(self.window_count(w))

    # -- pair counts ------------------------------------------------------
    def _union(self, w1, w2):
        """The distinct in-vocabulary words of the pairs, a (W,) lookup
        from word id to its index among them (-1: not asked about), and
        each pair's two indices (-1 for a word outside the corpus)."""
        w1 = _host(w1).astype(np.int64).reshape(-1)
        both = np.concatenate([w1, _host(w2).astype(np.int64).reshape(-1)])
        ok = (both >= 0) & (both < self.num_words)
        union = np.unique(both[ok])
        lut = torch.full((self.num_words,), -1, dtype=torch.int64,
                         device=self.device)
        lut[torch.as_tensor(union, device=self.device)] = torch.arange(
            len(union), device=self.device)
        idx = np.full(both.shape, -1, np.int64)
        idx[ok] = np.searchsorted(union, both[ok])
        return len(union), lut, idx[:len(w1)], idx[len(w1):]

    def co_doc_freq(self, w1, w2) -> np.ndarray:
        """D(w1, w2): documents containing both words of each pair."""
        n, lut, i1, i2 = self._union(w1, w2)
        out = np.zeros(len(i1), np.int64)
        if n == 0 or self.num_docs == 0:
            return out
        first = self._prev < 0
        u = lut[self._word.long()]
        keep = first & (u >= 0)
        docs, u = self._doc[keep].long(), u[keep]
        # int8 x int8 -> int32 products: _int_mm wants more than 16 rows
        # and multiples of 8 along the other dimensions
        n_pad = max(24, -(-n // 8) * 8)
        block = max(8, (_MEMBERSHIP_BYTES // n_pad) // 8 * 8)
        co = torch.zeros((n_pad, n_pad), dtype=torch.int32,
                         device=self.device)
        cuts = torch.searchsorted(
            docs, torch.arange(0, self.num_docs + block, block,
                               device=self.device)).cpu().tolist()
        for b, d0 in enumerate(range(0, self.num_docs, block)):
            lo, hi = cuts[b], cuts[b + 1]
            if lo == hi:
                continue
            rows = min(block, -(-(self.num_docs - d0) // 8) * 8)
            member = torch.zeros((rows, n_pad), dtype=torch.int8,
                                 device=self.device)
            member[docs[lo:hi] - d0, u[lo:hi]] = 1
            co += torch._int_mm(member.t().contiguous(), member)
        ok = (i1 >= 0) & (i2 >= 0)
        got = co[torch.as_tensor(i1[ok], device=self.device),
                 torch.as_tensor(i2[ok], device=self.device)]
        out[ok] = got.cpu().numpy()
        return out

    def co_window_count(self, w1, w2) -> np.ndarray:
        """Windows containing both words of each pair (a word paired with
        itself: its own window count)."""
        n, lut, i1, i2 = self._union(w1, w2)
        out = np.zeros(len(i1), np.int64)
        if n == 0:
            return out
        s, e = self.window, int(self._word.shape[0])
        table = torch.zeros(n * n, dtype=torch.int64, device=self.device)
        u = lut[self._word.long()]
        for d in range(1, min(s, e)):
            a, b = slice(0, e - d), slice(d, e)
            ua, ub = u[a], u[b]
            hit = ((self._doc[a] == self._doc[b]) & (ua >= 0) & (ub >= 0)
                   & (ua != ub)).nonzero().squeeze(1)
            if hit.numel() == 0:
                continue
            p = self._pos[a][hit].long()
            lo = torch.maximum(self._prev[a][hit], self._prev[b][hit])
            lo = torch.maximum(lo.long() + 1, p + d - s + 1).clamp_(min=0)
            hi = torch.minimum(p, self._last[a][hit].long())
            count = (hi - lo + 1).clamp_(min=0)
            x, y = ua[hit], ub[hit]
            table.index_add_(0, torch.minimum(x, y) * n
                             + torch.maximum(x, y), count)
        ok = (i1 >= 0) & (i2 >= 0)
        lo_i, hi_i = np.minimum(i1[ok], i2[ok]), np.maximum(i1[ok], i2[ok])
        got = table[torch.as_tensor(lo_i * n + hi_i,
                                    device=self.device)].cpu().numpy()
        same = lo_i == hi_i
        got[same] = self.window_count(_host(w1).reshape(-1)[ok][same])
        out[ok] = got
        return out

    def co_window_prob(self, w1, w2) -> np.ndarray:
        """Fraction of windows containing both words of each pair."""
        return self._prob(self.co_window_count(w1, w2))

    def _prob(self, count: np.ndarray) -> np.ndarray:
        if self.num_windows == 0:
            return np.zeros(count.shape)
        return count.astype(np.float64) / self.num_windows


def _pair_columns(top: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Each topic's (m, l) pairs, l < m, in the reference's loop order:
    the words ``top[:, m]`` and ``top[:, l]``, (K, P) each."""
    n = top.shape[1]
    ms = [m for m in range(1, n) for _ in range(m)]
    ls = [l for m in range(1, n) for l in range(m)]
    return top[:, ms], top[:, ls]


def umass_coherence(stats: CoherenceStats, top_words
                    ) -> Tuple[float, np.ndarray]:
    """UMass coherence per topic + mean over topics.

    ``top_words`` is the (K, N) matrix from :func:`top_topic_words`
    (tensor or numpy), rows ordered by descending count. Returns
    ``(mean, per_topic)``; each topic's terms are added in the
    reference's pair order."""
    top = _host(top_words).astype(np.int64)
    per_topic = np.zeros(top.shape[0], np.float64)
    if top.shape[1] >= 2:
        wm, wl = _pair_columns(top)
        d_l = stats.doc_freq(wl.ravel()).reshape(wl.shape)
        co = stats.co_doc_freq(wm.ravel(), wl.ravel()).reshape(wl.shape)
        terms = np.zeros(wl.shape, np.float64)
        ok = d_l > 0  # a denominator word absent from the corpus: skipped
        terms[ok] = np.log((co[ok] + 1.0) / d_l[ok])
        per_topic = np.cumsum(terms, axis=1)[:, -1]
    return float(per_topic.mean()), per_topic


def npmi_coherence(stats: CoherenceStats, top_words
                   ) -> Tuple[float, np.ndarray]:
    """Sliding-window NPMI coherence per topic + mean over topics.

    Pairs are unordered; each topic's score is the mean pairwise NPMI in
    [-1, 1] over the pairs whose words both occur (0 with none), with
    never-co-occurring pairs at -1."""
    top = _host(top_words).astype(np.int64)
    per_topic = np.zeros(top.shape[0], np.float64)
    if top.shape[1] >= 2:
        wm, wl = _pair_columns(top)
        p_i = stats.window_prob(wl.ravel()).reshape(wl.shape)
        p_j = stats.window_prob(wm.ravel()).reshape(wl.shape)
        p_ij = stats.co_window_prob(wl.ravel(), wm.ravel()).reshape(wl.shape)
        vals = np.where(p_ij == 0.0, -1.0, 1.0)
        mid = (p_ij > 0.0) & (p_ij < 1.0)
        vals[mid] = (np.log(p_ij[mid] / (p_i[mid] * p_j[mid]))
                     / (-np.log(p_ij[mid])))
        evidence = (p_i != 0.0) & (p_j != 0.0)
        for t in range(top.shape[0]):
            row = vals[t][evidence[t]]
            per_topic[t] = np.mean(row) if row.size else 0.0
    return float(per_topic.mean()), per_topic
