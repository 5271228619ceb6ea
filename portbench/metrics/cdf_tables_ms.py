"""cdf_tables_ms (ms): device time a sweep inside the program's span
``zen_cdf.tables`` (``build_cdf_tables``: the Eq. 3 terms, ``g_cdf``, the
``m2_all`` matvec, ``doc_topk``'s blocks), from the span's CUDA events.
Layer: the algorithms (``algorithms/zen_cdf.py``)."""
from portbench.metrics._program_trace import span_ms


def read(record):
    return span_ms(record, "zen_cdf.tables")
