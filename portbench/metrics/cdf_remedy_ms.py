"""cdf_remedy_ms (ms): device time a sweep inside the program's span
``zen_cdf.remedy``, once a chunk (the paper's §3.1 remedy and the final
``where``), from the span's CUDA events. Layer: the algorithms
(``algorithms/zen_cdf.py``)."""
from portbench.metrics._program_trace import span_ms


def read(record):
    return span_ms(record, "zen_cdf.remedy")
