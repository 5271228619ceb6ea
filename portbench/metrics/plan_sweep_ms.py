"""plan_sweep_ms (ms): device time a sweep inside the program's span
``plan.sweep`` (``SingleBoxPlan.step``: the backend's draw and the mask's
``where``), from the span's CUDA events. Layer: the session
(``train/session.py``)."""
from portbench.metrics._program_trace import span_ms


def read(record):
    return span_ms(record, "plan.sweep")
