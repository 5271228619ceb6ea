"""plan_merge_ms (ms): device time a sweep inside the program's span
``plan.merge`` (``core/counts.py`` ``delta_counts``: kernel 5 on the word
and doc rows, the ``d_k`` column sum), from the span's CUDA events.
Layer: the counts."""
from portbench.metrics._program_trace import span_ms


def read(record):
    return span_ms(record, "plan.merge")
