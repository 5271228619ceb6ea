"""topic_histogram_roofline (%): kernel 5's least time on the window's
delta merges (``roofline.topic_histogram_bytes``, one merge a sweep) over
the device time of its kernels, matched by name. Layer: the kernels
(``kernels/csrc/topic_histogram.cu``, called by ``core/counts.py``)."""
from portbench import roofline
from portbench.trace import device_time

KERNELS = ("hist_sorted_kernel", "zero_cut_rows_kernel")


def read(record):
    seconds, launches = device_time(record, KERNELS)
    s = record["shape"]
    least = roofline.least_seconds(
        record["device_kind"],
        nbytes=roofline.topic_histogram_bytes(s["tokens"], s["words"],
                                              s["docs"], s["topics"]))
    if not launches or least is None:
        return None
    return 100.0 * least * record["sweeps"] / seconds
