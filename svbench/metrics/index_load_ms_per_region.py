"""METER span ``index_load`` (each sample's genome index, loaded from the
cache or built, and its sharded wrap) over the window's regions, in ms."""

from svbench.metrics._runner import span_ms


def read(record):
    return span_ms(record, "index_load")
