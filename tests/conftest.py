"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests must see the real
single CPU device; multi-device tests spawn subprocesses (helpers.py)."""
import jax
import numpy as np
import pytest

from repro.core.types import LDAHyperParams
from repro.data import synthetic_lda_corpus


@pytest.fixture(scope="session")
def tiny_corpus():
    corpus, phi = synthetic_lda_corpus(
        seed=0, num_docs=40, num_words=60, num_topics=6, avg_doc_len=30
    )
    return corpus


@pytest.fixture(scope="session")
def tiny_hyper():
    return LDAHyperParams(num_topics=6, alpha=0.1, beta=0.05)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def key():
    return jax.random.key(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the PyTorch port's kernels); skips "
        "without one. Run on the card with: pytest -m gpu",
    )
