"""Serving (``repro/serving``): the LM engine, and frozen-model LDA
serving with its sharded form and the replica router."""
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: F401
from repro_torch.serving.lda_engine import (  # noqa: F401
    CheckpointWatcher,
    FrozenLDAModel,
    InferRequest,
    LDAEngine,
    LDAServeConfig,
    doc_completion_perplexity,
    docs_from_corpus,
    latency_percentile,
)
from repro_torch.serving.router import LDARouter  # noqa: F401
from repro_torch.serving.sharded import ShardedFrozenLDAModel  # noqa: F401
