"""Streaming corpus sources: document windows over a stable vocabulary
(``repro/data/stream.py``).

A :class:`CorpusSource` yields :class:`Window`\\ s, each a self-contained
:class:`~repro_torch.core.types.Corpus` whose doc ids are local to the
window and whose ``num_words`` is the source's global vocabulary, so
every window indexes the same (W, K) word-topic matrix:

* :class:`ReplaySource` — rotation over an in-memory corpus in doc
  windows, ``epochs`` times, with a stable ``uid`` per doc slice;
* :class:`LibsvmStreamSource` — the next ``window_docs`` documents of a
  libsvm file through one open handle, resumable at an exact document
  cursor;
* :class:`DriftSource` — a synthetic stream whose LDA topics random-walk
  between windows, deterministic in (seed, window index).

Windows are built on the host as torch CPU tensors (the session moves
each one to its device). Every source draws only numpy randomness, so a
window is bit-equal to the reference's: the same words, docs,
``num_docs``, ``uid``, ``index`` and ``token_index``. ``windows(start=k)``
yields windows ``k, k+1, ...`` equal to the tail of ``windows()``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.types import Corpus
from repro_torch.data.corpus import _corpus, load_libsvm, skip_libsvm_docs


@dataclasses.dataclass(frozen=True)
class Window:
    """One streamed document window: ``corpus`` (doc ids in
    ``[0, corpus.num_docs)``, the source's vocabulary), ``index`` (the
    position in the stream, the resume cursor), ``uid`` (the doc slice's
    identity, reused when a replaying source comes round again) and, for
    :class:`ReplaySource`, ``token_index`` (the window's tokens as edge
    indices of the source corpus)."""

    corpus: Corpus
    index: int
    uid: str
    token_index: Optional[np.ndarray] = None


class CorpusSource:
    """Protocol: iterate document windows under a stable vocabulary.

    ``replays``: a uid can come round more than once (only then are a
    window's assignments worth retaining). ``supports_doc_resume``:
    ``windows`` takes ``start_docs``, the exact count of documents
    already consumed (a file source's last window may be short)."""

    num_words: int
    window_docs: int
    replays: bool = False
    supports_doc_resume: bool = False

    def windows(self, start: int = 0) -> Iterator[Window]:
        raise NotImplementedError


class ReplaySource(CorpusSource):
    """Rotate over an in-memory corpus in ``ceil(D / window_docs)`` doc
    slices, ``epochs`` times; slice ``s`` keeps uid ``w<s>``."""

    replays = True

    def __init__(self, corpus: Corpus, window_docs: int, epochs: int = 1):
        if window_docs <= 0:
            raise ValueError(f"window_docs must be > 0, got {window_docs}")
        if epochs <= 0:
            raise ValueError(f"epochs must be > 0, got {epochs}")
        self.corpus = corpus
        self.window_docs = int(window_docs)
        self.epochs = int(epochs)
        self.num_words = corpus.num_words
        # doc-major token order, computed once (a stable argsort); each
        # window's tokens are a contiguous range of it
        docs = np.asarray(corpus.doc.cpu().numpy())
        self._order = np.argsort(docs, kind="stable")
        self._docs = docs[self._order]
        self._words = corpus.word.cpu().numpy()[self._order]
        self._bounds = np.searchsorted(self._docs,
                                       np.arange(corpus.num_docs + 1))
        self.windows_per_epoch = -(-corpus.num_docs // self.window_docs)

    @property
    def num_windows(self) -> int:
        return self.windows_per_epoch * self.epochs

    def window_slice(self, slice_index: int) -> Window:
        """The window of doc slice ``slice_index`` (``index`` is the slice;
        ``windows()`` stamps the stream index)."""
        d0 = slice_index * self.window_docs
        d1 = min(d0 + self.window_docs, self.corpus.num_docs)
        t0, t1 = self._bounds[d0], self._bounds[d1]
        cw = Corpus(
            word=torch.from_numpy(self._words[t0:t1]),
            doc=torch.from_numpy((self._docs[t0:t1] - d0).astype(np.int32)),
            num_words=self.num_words,
            num_docs=d1 - d0,
        )
        return Window(corpus=cw, index=slice_index, uid=f"w{slice_index}",
                      token_index=self._order[t0:t1])

    def windows(self, start: int = 0) -> Iterator[Window]:
        for i in range(start, self.num_windows):
            w = self.window_slice(i % self.windows_per_epoch)
            yield dataclasses.replace(w, index=i)


class LibsvmStreamSource(CorpusSource):
    """Tail a libsvm file in windows of ``window_docs`` documents through
    one open handle: nothing is re-read, only the current window is
    resident. ``num_words`` is required (a chunk cannot tell the global
    vocabulary). ``windows(start=k)`` skips ``k * window_docs`` documents,
    or exactly ``start_docs`` when given (the session's cursor: a window
    cut short at EOF must neither be re-read nor over-skipped)."""

    supports_doc_resume = True

    def __init__(self, path: str, window_docs: int, num_words: int):
        if window_docs <= 0:
            raise ValueError(f"window_docs must be > 0, got {window_docs}")
        if num_words <= 0:
            raise ValueError(
                "LibsvmStreamSource needs the global vocabulary size "
                f"(num_words > 0), got {num_words}"
            )
        self.path = path
        self.window_docs = int(window_docs)
        self.num_words = int(num_words)

    def windows(self, start: int = 0,
                start_docs: Optional[int] = None) -> Iterator[Window]:
        with open(self.path) as f:
            skip = (start * self.window_docs if start_docs is None
                    else int(start_docs))
            if skip:
                skip_libsvm_docs(f, skip)
            index = start
            while True:
                cw = load_libsvm(f, num_words=self.num_words,
                                 max_docs=self.window_docs)
                if cw.num_docs == 0:
                    return
                yield Window(corpus=cw, index=index, uid=f"w{index}")
                index += 1


class DriftSource(CorpusSource):
    """Synthetic non-stationary stream: window ``i`` is drawn from
    ``phi_i = normalize((1 - drift) phi_{i-1} + drift noise_i)`` (fresh
    Dirichlet noise per window) with fresh Dirichlet thetas per document,
    all seeded from ``(seed, stream, window index)``; ``windows(start=k)``
    recomputes the phi chain up to ``k`` without emitting windows."""

    def __init__(self, seed: int, window_docs: int, num_windows: int,
                 num_words: int, num_topics: int = 8, avg_doc_len: int = 40,
                 drift: float = 0.25, alpha: float = 0.1,
                 beta: float = 0.05):
        if window_docs <= 0:
            raise ValueError(f"window_docs must be > 0, got {window_docs}")
        if not 0.0 <= drift <= 1.0:
            raise ValueError(f"drift must be in [0, 1], got {drift}")
        self.seed = int(seed)
        self.window_docs = int(window_docs)
        self.num_windows = int(num_windows)
        self.num_words = int(num_words)
        self.num_topics = int(num_topics)
        self.avg_doc_len = int(avg_doc_len)
        self.drift = float(drift)
        self.alpha = float(alpha)
        self.beta = float(beta)

    def _rng(self, index: int, stream: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, stream, index])

    def _noise(self, index: int) -> np.ndarray:
        return self._rng(index, 0).dirichlet(
            np.full(self.num_words, self.beta), size=self.num_topics)

    def _drifted(self, phi: np.ndarray, index: int) -> np.ndarray:
        phi = (1.0 - self.drift) * phi + self.drift * self._noise(index)
        phi /= phi.sum(axis=1, keepdims=True)
        return phi

    def _phi(self, index: int) -> np.ndarray:
        """The drift chain up to window ``index``, (K, W), rows sum to 1."""
        phi = self._noise(0)
        for i in range(1, index + 1):
            phi = self._drifted(phi, i)
        return phi

    def _window(self, index: int, phi: np.ndarray) -> Window:
        rng = self._rng(index, 1)
        theta = rng.dirichlet(np.full(self.num_topics, self.alpha),
                              size=self.window_docs)
        lengths = np.maximum(1, rng.poisson(self.avg_doc_len,
                                            size=self.window_docs))
        words_list, docs_list = [], []
        for d in range(self.window_docs):
            zs = rng.choice(self.num_topics, size=lengths[d], p=theta[d])
            for z in np.unique(zs):
                n = int((zs == z).sum())
                words_list.append(rng.choice(self.num_words, size=n,
                                             p=phi[z]))
                docs_list.append(np.full(n, d, dtype=np.int32))
        cw = _corpus(np.concatenate(words_list), np.concatenate(docs_list),
                     self.num_words, self.window_docs)
        return Window(corpus=cw, index=index, uid=f"w{index}")

    def windows(self, start: int = 0) -> Iterator[Window]:
        if start >= self.num_windows:
            return
        phi = self._phi(start)
        for i in range(start, self.num_windows):
            if i > start:
                phi = self._drifted(phi, i)
            yield self._window(i, phi)


def make_source(spec: str, window_docs: int, *,
                corpus: Optional[Corpus] = None,
                num_words: Optional[int] = None, epochs: int = 1,
                num_windows: int = 8, seed: int = 0) -> CorpusSource:
    """A :class:`CorpusSource` from a ``RunConfig.stream_source`` spec:
    ``"replay"`` (needs ``corpus``), ``"libsvm:<path>"`` or
    ``"drift[:<seed>]"`` (both need ``num_words``)."""
    kind, _, arg = spec.partition(":")
    if kind == "replay":
        if corpus is None:
            raise ValueError("stream_source 'replay' needs a corpus")
        return ReplaySource(corpus, window_docs, epochs=epochs)
    if kind == "libsvm":
        if not arg:
            raise ValueError("stream_source 'libsvm:<path>' needs a path")
        if not num_words:
            raise ValueError("stream_source 'libsvm' needs num_words")
        return LibsvmStreamSource(arg, window_docs, num_words)
    if kind == "drift":
        if not num_words:
            raise ValueError("stream_source 'drift' needs num_words")
        return DriftSource(seed=int(arg) if arg else seed,
                           window_docs=window_docs, num_windows=num_windows,
                           num_words=num_words)
    raise ValueError(
        f"unknown stream_source {spec!r}: expected replay | "
        f"libsvm:<path> | drift[:<seed>]"
    )
