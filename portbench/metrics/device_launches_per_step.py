"""device_launches_per_step (launches): kernels, copies and fills that
ran on the card in the traced window, per sweep. Layer: the algorithms
(``algorithms/zen_pallas.py``, ``algorithms/zen_cdf.py``,
``core/sampler.py``)."""


def read(record):
    if not record["sweeps"] or not record["device"]["launches"]:
        return None
    return record["device"]["launches"] / record["sweeps"]
