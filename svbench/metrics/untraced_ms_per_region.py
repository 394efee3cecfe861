"""The samples' wall less every METER span in their ``stage_s``, over the
window's regions, in ms: what no span of the program covers. None for a
program without the runner's spans (there it would repeat
other_ms_per_region)."""

from svbench.metrics._common import regions
from svbench.metrics._runner import SPANS, spanned


def read(record):
    n = regions(record)
    if not n or not spanned(record, *SPANS):
        return None
    passes = record["passes"]
    return 1000.0 * sum(p["wall"] - sum(p["stage_s"].values()) for p in passes) / n
