"""Corpus generation and libsvm IO (``repro/data``)."""
