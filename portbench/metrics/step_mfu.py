"""step_mfu (%): the model's work in the window's sweeps (Eq. 3 at every
token and topic, ``roofline.sweep_flops``) over the card's float32 peak
times the window's wall time. Layer: the session
(``TrainSession.step``)."""
from portbench import roofline


def read(record):
    shape, sweeps = record["shape"], record["sweeps"]
    least = roofline.least_seconds(
        record["device_kind"],
        flops=roofline.sweep_flops(shape["tokens"], shape["topics"]) * sweeps)
    if least is None or not sweeps:
        return None
    return 100.0 * least / record["window_s"]
