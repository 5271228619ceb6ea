"""Corpus generation, libsvm IO and windowed corpus sources
(``repro/data``)."""
from repro_torch.data.corpus import (  # noqa: F401
    load_libsvm,
    save_libsvm,
    skip_libsvm_docs,
    synthetic_corpus,
    synthetic_lda_corpus,
)
from repro_torch.data.stream import (  # noqa: F401
    CorpusSource,
    DriftSource,
    LibsvmStreamSource,
    ReplaySource,
    Window,
    make_source,
)
