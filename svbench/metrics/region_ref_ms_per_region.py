"""METER span ``region_ref`` (each region's reference: the cached codes or
the fetch, and its seed index) over the window's regions, in ms."""

from svbench.metrics._runner import span_ms


def read(record):
    return span_ms(record, "region_ref")
