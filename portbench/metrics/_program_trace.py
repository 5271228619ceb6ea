"""The readers of the program's own spans and counters
(``repro_torch.observe.trace_totals``: the profiled window's totals),
per sweep. A program without the collector, or without the span or
counter, reads None; so does a span's device time off the card, where
a span records no CUDA events."""


def _totals():
    try:
        from repro_torch.observe import trace_totals
    except ImportError:  # a program that keeps no spans
        return None
    return trace_totals()


def span_ms(record, name):
    """Device milliseconds a sweep inside the program's span ``name``."""
    totals = _totals()
    entry = None if totals is None else totals["spans"].get(name)
    if entry is None or entry["device_s"] is None or not record["sweeps"]:
        return None
    return 1e3 * entry["device_s"] / record["sweeps"]


def count_per_sweep(record, name):
    """The program's counter ``name`` over the window, a sweep."""
    totals = _totals()
    value = None if totals is None else totals["counters"].get(name)
    if value is None or not record["sweeps"]:
        return None
    return value / record["sweeps"]
