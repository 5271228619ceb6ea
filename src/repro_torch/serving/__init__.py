"""Frozen-model LDA serving (``repro/serving``, engine only)."""
from repro_torch.serving.lda_engine import (  # noqa: F401
    FrozenLDAModel,
    InferRequest,
    LDAEngine,
    LDAServeConfig,
    doc_completion_perplexity,
    docs_from_corpus,
    latency_percentile,
)
