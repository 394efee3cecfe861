"""Target regions completed by the window's Runner.run() calls, over the
window's seconds (host clock; whole samples only)."""

from svbench.metrics._common import regions


def read(record):
    return regions(record) / record["window_s"] if record["window_s"] > 0 else None
