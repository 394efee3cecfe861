"""95th percentile of the runner ledger's per-region elapsed_s over every
region of the window (the serial path's host clock around a region)."""

import numpy as np


def read(record):
    if record["cfg"]["runner"]["batch_regions"]:
        return None  # the batched ledger times classification alone
    vals = [v for p in record["passes"] for v in p["region_s"]]
    return float(np.percentile(vals, 95)) if vals else None
