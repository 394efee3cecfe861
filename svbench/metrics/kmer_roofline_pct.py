"""The k-mer engine's least time over its kernels' and sorts' profiler time."""

from svbench import roofline
from svbench.roofline import kmer


def read(record):
    peak = roofline.peaks(record["device_name"])
    if not record["trace"] or peak is None:
        return None
    return roofline.share_pct(kmer.least_seconds(record["kmer_calls"], peak), record["trace"]["kernel_s"],
                              kmer.KERNELS)
