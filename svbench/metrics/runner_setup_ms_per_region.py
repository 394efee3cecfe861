"""METER span ``setup`` (each sample's ``Runner.setup`` but the index: the
config, the logger, the device, the BED, the reference's open, the repeat
mask and filters) over the window's regions, in ms."""

from svbench.metrics._runner import span_ms


def read(record):
    return span_ms(record, "setup")
