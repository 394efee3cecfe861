"""The samples' wall time outside every METER stage (Runner set-up, the
normal's reads, reference fetches, the ledger and output files), over
the window's regions, in ms."""

from svbench.metrics._common import STAGES, regions, stage_s


def read(record):
    n = regions(record)
    if not n:
        return None
    wall = sum(p["wall"] for p in record["passes"])
    return 1000.0 * (wall - stage_s(record, *STAGES)) / n
