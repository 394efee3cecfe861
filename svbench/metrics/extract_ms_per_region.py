"""METER stage seconds (bam_decode and extract_clean) over the window's regions, in ms."""

from svbench.metrics._common import per_region_ms


def read(record):
    return per_region_ms(record, "bam_decode", "extract_clean")
