"""cdf_draws_ms (ms): device time a sweep inside the program's span
``zen_cdf.draws``, twice a chunk (``stream_uniforms``; then both draws:
the shared search, kernel 7, the row search, the gathers), from the
span's CUDA events. Layer: the algorithms (``algorithms/zen_cdf.py``)."""
from portbench.metrics._program_trace import span_ms


def read(record):
    return span_ms(record, "zen_cdf.draws")
