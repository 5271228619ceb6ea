"""Self-tuning autopilot: decide from measured windows
(``repro/autotune``).

``repro_torch.observe`` measures; this package decides. The policies
consume windows of telemetry records and emit typed decisions — they
never touch an engine or a plan themselves. ``TrainSession``'s
``autopilot`` schedule action applies training decisions at rebuild
points, and ``LDAEngine`` applies serving decisions between admission
ticks (bucket grids only once every bucket has drained).
"""
from repro_torch.autotune.policy import (  # noqa: F401
    BackendSwitch,
    Decision,
    RowRepad,
    ServeAutopilot,
    ServeRetune,
    TrainAutopilot,
)
