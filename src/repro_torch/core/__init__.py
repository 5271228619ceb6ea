"""Core LDA types, counts, request keys and frozen-model inference
(``repro/core``). ``LDATrainer`` / ``TrainConfig`` are the deprecated
single-box shims over ``train.session.TrainSession``."""
from repro_torch.core.types import CGSState, Corpus, LDAHyperParams  # noqa: F401
from repro_torch.core.trainer import LDATrainer, TrainConfig  # noqa: F401
