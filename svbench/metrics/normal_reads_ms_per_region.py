"""METER span ``normal_reads`` (each region's reads of the matched normal,
decoded from its BAM) over the window's regions, in ms. None for a sample
without a normal."""

from svbench.metrics._runner import span_ms


def read(record):
    return span_ms(record, "normal_reads")
