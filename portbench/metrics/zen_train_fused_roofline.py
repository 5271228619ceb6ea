"""zen_train_fused_roofline (%): kernel 2's least time on the window's
sweeps (Eq. 3 at every token and topic, and its bytes, once a sweep) over
its device time, matched by the kernel's name, however many launches a
sweep takes. Layer: the kernels (``kernels/csrc/zen_train.cu``)."""
from portbench import roofline
from portbench.trace import device_time

KERNELS = ("zen_train_fused_kernel",)


def read(record):
    seconds, launches = device_time(record, KERNELS)
    s = record["shape"]
    least = roofline.least_seconds(
        record["device_kind"],
        flops=roofline.sweep_flops(s["tokens"], s["topics"]),
        nbytes=roofline.zen_train_fused_bytes(s["tokens"], s["words"],
                                              s["docs"], s["topics"]))
    if not launches or least is None:
        return None
    return 100.0 * least * record["sweeps"] / seconds
