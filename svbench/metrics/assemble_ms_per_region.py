"""METER stage seconds (assemble) over the window's regions, in ms."""

from svbench.metrics._common import per_region_ms


def read(record):
    return per_region_ms(record, "assemble")
