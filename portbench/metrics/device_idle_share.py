"""device_idle_share (%): the share of the traced window in which no
operation ran on the card. Layer: the device."""


def read(record):
    busy = record["device"]["busy_s"]
    if not busy:
        return None
    return 100.0 * (1.0 - busy / record["window_s"])
