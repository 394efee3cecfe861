"""What the readers of the runner's own spans share. The program writes
these METER stages into each sample's ``metrics.json`` (``stage_s``); a
program without them gives every reader None."""

from typing import Optional

from svbench.metrics._common import per_region_ms

# the spans around a sample's work outside the six stages of _common.STAGES
SPANS = ("setup", "index_load", "region_ref", "normal_reads", "ledger", "finalize")


def spanned(record: dict, *names: str) -> bool:
    return any(n in p["stage_s"] for p in record["passes"] for n in names)


def span_ms(record: dict, *names: str) -> Optional[float]:
    """The spans' seconds over the window's regions, in ms; None where no
    sample has any of them."""
    return per_region_ms(record, *names) if spanned(record, *names) else None
