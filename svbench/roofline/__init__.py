"""The work of each kernel family, counted by the benchmark from the
unpadded shapes of the calls the window made, so it reads the same
whatever implements the call; and the declared peaks of each card."""

import json
from pathlib import Path
from typing import Optional


def peaks(device_name: Optional[str]) -> Optional[dict]:
    table = json.loads((Path(__file__).with_name("peaks.json")).read_text())
    return table.get(device_name) if device_name else None


def share_pct(least_s: float, kernel_s: dict, patterns) -> Optional[float]:
    """100 x the least time over the device time of the kernels whose
    names hold one of ``patterns``; None where no such kernel ran."""
    dev = sum(s for name, s in kernel_s.items() if any(p in name for p in patterns))
    if dev <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / dev
