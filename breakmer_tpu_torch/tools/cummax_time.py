"""Times of the running-max kernel's wrapper at given shapes, on the card.

    python /path/to/breakmer_tpu_torch/tools/cummax_time.py R,W [R,W ...] [--warps 1,2,4,8]

Run from the root of a checkout, it times the ``probe_mosaic_cummax.cummax``
of the ``breakmer_tpu_torch`` found there (the current directory goes
first on ``sys.path``), with the timing of the checkout this script lives
in, so one copy of the script times two checkouts alike: run it from
each, in turns, within one run on one card. For each shape, on
full-range int32 from seed 8: whether the kernel equals
``torch.cummax(x, 1).values``; the device time of the kernel and of
``torch.cummax`` from queued calls (``timing.queued_ms``, the median of
5 windows) and from the profiler (``timing.device_us``); and a call's
time of both taken in turns, 400 each (``timing.turns_us``), with their
ratio. ``--warps`` adds the kernel's queued device time at each forced
number of warps a block (a checkout whose ``cummax`` takes ``warps``).
Prints one JSON line with the times in µs, the tree and the card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve()


def _timing():
    """This script's own checkout's ``timing`` module, loaded by path."""
    spec = importlib.util.spec_from_file_location("_cummax_time_timing",
                                                  HERE.parents[1] / "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="cummax_time.py")
    p.add_argument("shapes", nargs="+", help="R,W")
    p.add_argument("--warps", default="", help="forced warps a block, e.g. 1,2,4,8")
    args = p.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from breakmer_tpu_torch.tools import probe_mosaic_cummax as cm

    if not torch.cuda.is_available():
        raise RuntimeError("cummax_time needs a CUDA card")
    timing = _timing()
    dev = torch.device("cuda")
    warps = [int(w) for w in args.warps.split(",") if w]
    out = {}
    for shape in args.shapes:
        R, W = (int(v) for v in shape.split(","))
        x = torch.from_numpy(np.random.default_rng(8).integers(
            -2**31, 2**31, (R, W), dtype=np.int64).astype(np.int32)).to(dev)
        kern, lib = (lambda: cm.cummax(x)), (lambda: torch.cummax(x, dim=-1))
        exact = torch.equal(kern(), lib().values)
        k_us, t_us = timing.turns_us(kern, lib)
        out[f"{R}x{W}"] = dict(
            exact=exact,
            device_us=statistics.median(timing.queued_ms(kern) * 1e3 for _ in range(5)),
            library_device_us=statistics.median(timing.queued_ms(lib) * 1e3
                                                for _ in range(5)),
            profiler_device_us=timing.device_us(kern),
            library_profiler_device_us=timing.device_us(lib),
            call_us=k_us, library_call_us=t_us, call_ratio=k_us / t_us,
            warps_device_us={w: statistics.median(
                timing.queued_ms(lambda: cm.cummax(x, warps=w)) * 1e3 for _ in range(5))
                for w in warps})
        del x
    print(json.dumps({"cummax_us": out, "tree": os.getcwd(), "card": timing.card_line()}))


if __name__ == "__main__":
    main()
