"""plan_update_ms (ms): device time a sweep inside the program's span
``plan.update``, entered twice a step (``active_mask`` before the sweep;
``update_exclusion_stats`` and the three count adds after the merge),
from the span's CUDA events. Layer: the session
(``train/session.py``)."""
from portbench.metrics._program_trace import span_ms


def read(record):
    return span_ms(record, "plan.update")
