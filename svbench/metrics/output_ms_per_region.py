"""METER spans ``ledger`` (each region's rows, VCF records and ledger line)
and ``finalize`` (each sample's ledger, svs.out and VCF) over the window's
regions, in ms."""

from svbench.metrics._runner import span_ms


def read(record):
    return span_ms(record, "ledger", "finalize")
