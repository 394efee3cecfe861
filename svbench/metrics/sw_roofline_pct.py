"""The SW kernel's least time over its profiler time (both launch forms)."""

from svbench import roofline
from svbench.roofline import sw


def read(record):
    peak = roofline.peaks(record["device_name"])
    if not record["trace"] or peak is None:
        return None
    return roofline.share_pct(sw.least_seconds(record["sw_calls"], peak), record["trace"]["kernel_s"], sw.KERNELS)
