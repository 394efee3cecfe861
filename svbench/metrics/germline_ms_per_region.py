"""METER span ``germline`` (the germline recheck of each region's events
against the matched normal: the k-mer test, the normal reads that hold
seeds of both flanks, their alignments) over the window's regions, in ms.
None for a program without the span and for a sample without a normal."""

from svbench.metrics._runner import span_ms


def read(record):
    return span_ms(record, "germline")
