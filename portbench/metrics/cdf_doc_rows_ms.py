"""cdf_doc_rows_ms (ms): device time a sweep inside the program's span
``zen_cdf.doc_rows``, once a chunk (``doc_rows``: the ``kd_idx``/``kd_cnt``
and ``n_wk`` gathers, the term-3 ``cumsum``), from the span's CUDA
events. Layer: the algorithms (``algorithms/zen_cdf.py``)."""
from portbench.metrics._program_trace import span_ms


def read(record):
    return span_ms(record, "zen_cdf.doc_rows")
