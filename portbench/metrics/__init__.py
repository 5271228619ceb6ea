"""Per-layer metric readers: ``metrics/<metric>.py`` defines
``read(record) -> float | None``. A reader that finds nothing to read
returns None, and the metric is left out of the line. The record is
``trace.record``'s: the cell, its shape, the window's sweeps and wall
time, the card's name, and the device events by name."""
