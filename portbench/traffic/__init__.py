"""Traffic: a mix is a data file ``traffic/<name>.json`` of parameters
that one general generator reads (``lda_corpus`` for corpora)."""
