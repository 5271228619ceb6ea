"""Corpus generation and IO (``repro/data/corpus.py``).

The generators are the reference's numpy ``default_rng`` code, so the same
seed gives the same corpus in both packages; only the container differs
(torch CPU tensors instead of jax arrays).

* ``synthetic_corpus``     — Zipf word frequencies, Poisson doc lengths.
* ``synthetic_lda_corpus`` — documents drawn from an LDA model with known
  topics (returns the true phi for recovery checks).
* ``load_libsvm/save_libsvm`` — one line per doc, ``label word_id:count``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import Corpus


def _corpus(words: np.ndarray, docs: np.ndarray, num_words: int,
            num_docs: int) -> Corpus:
    return Corpus(
        word=torch.from_numpy(np.asarray(words, np.int32)),
        doc=torch.from_numpy(np.asarray(docs, np.int32)),
        num_words=num_words, num_docs=num_docs,
    )


def synthetic_corpus(
    seed: int,
    num_docs: int,
    num_words: int,
    avg_doc_len: int,
    zipf_a: float = 1.2,
) -> Corpus:
    """Zipf-distributed words, Poisson doc lengths. Token-level."""
    rng = np.random.default_rng(seed)
    lengths = np.maximum(1, rng.poisson(avg_doc_len, size=num_docs))
    total = int(lengths.sum())
    ranks = np.arange(1, num_words + 1, dtype=np.float64)
    pmf = ranks ** (-zipf_a)
    pmf /= pmf.sum()
    words = rng.choice(num_words, size=total, p=pmf).astype(np.int32)
    docs = np.repeat(np.arange(num_docs, dtype=np.int32), lengths)
    return _corpus(words, docs, num_words, num_docs)


def synthetic_lda_corpus(
    seed: int,
    num_docs: int,
    num_words: int,
    num_topics: int,
    avg_doc_len: int,
    alpha: float = 0.1,
    beta: float = 0.05,
) -> Tuple[Corpus, np.ndarray]:
    """Documents from the LDA generative process (paper Eq. 1).

    Returns (corpus, true_phi (K, W))."""
    rng = np.random.default_rng(seed)
    phi = rng.dirichlet(np.full(num_words, beta), size=num_topics)
    theta = rng.dirichlet(np.full(num_topics, alpha), size=num_docs)
    lengths = np.maximum(1, rng.poisson(avg_doc_len, size=num_docs))
    words_list, docs_list = [], []
    for d in range(num_docs):
        zs = rng.choice(num_topics, size=lengths[d], p=theta[d])
        for z in np.unique(zs):
            n = int((zs == z).sum())
            words_list.append(rng.choice(num_words, size=n, p=phi[z]))
            docs_list.append(np.full(n, d, dtype=np.int32))
    words = np.concatenate(words_list).astype(np.int32)
    docs = np.concatenate(docs_list).astype(np.int32)
    return _corpus(words, docs, num_words, num_docs), phi


def save_libsvm(corpus: Corpus, path: str) -> None:
    """Write doc-major libsvm lines: ``0 word:count ...``."""
    words = corpus.word.numpy()
    docs = corpus.doc.numpy()
    order = np.argsort(docs, kind="stable")
    words, docs = words[order], docs[order]
    with open(path, "w") as f:
        boundaries = np.searchsorted(docs, np.arange(corpus.num_docs + 1))
        for d in range(corpus.num_docs):
            ws = words[boundaries[d]: boundaries[d + 1]]
            uniq, cnt = np.unique(ws, return_counts=True)
            f.write(
                "0 " + " ".join(f"{w}:{c}" for w, c in zip(uniq, cnt)) + "\n"
            )


def load_libsvm(
    path_or_buf,
    num_words: Optional[int] = None,
    max_docs: Optional[int] = None,
) -> Corpus:
    """Read libsvm lines into a token-level corpus (counts expanded).

    ``path_or_buf`` is a path or an open handle; with ``max_docs`` set,
    reading stops after that many documents and leaves a handle at the
    next unread line. Doc ids are 0-based and local to the read."""
    if isinstance(path_or_buf, (str, bytes)):
        f = open(path_or_buf)
    else:
        f = path_or_buf
    words_list, docs_list = [], []
    d = 0
    max_w = -1
    try:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            for tok in parts[1:]:
                w, c = tok.split(":")
                w, c = int(w), int(float(c))
                max_w = max(max_w, w)
                words_list.extend([w] * c)
                docs_list.extend([d] * c)
            d += 1
            if max_docs is not None and d >= max_docs:
                break
    finally:
        if f is not path_or_buf:
            f.close()
    return _corpus(np.asarray(words_list, np.int32),
                   np.asarray(docs_list, np.int32),
                   num_words or (max_w + 1), d)
