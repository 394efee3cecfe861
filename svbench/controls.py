"""The readings that the limits of ``correct`` are set from, on the card
at a cell's own size: for each seed, one set-up, a window of every sample
read soundly (the lower readings), the controls (the reference at the
precision below, in the program's place) on that window's captures, and
a window for each fault planted under the timed path (the upper
readings). The benchmark's own runs never run this.

    python3 -m svbench.controls --workload <cell> --seeds 11,12,13 \\
        [--controls kmer_table_16,sw_int16,pos_16bit] [--faults sw_half,sw_unhooked]

One JSON line a reading: the seed, the mode and every number compared.
It needs the cell's CUDA cards and exits 2 without a reading where they
are missing; ``--rehearse`` reads the same at a tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from svbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="svbench.controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="kmer_table_16,sw_int16,pos_16bit")
    ap.add_argument("--faults", default="")
    ap.add_argument("--rehearse", action="store_true", help="a tiny size, on the CPU")
    args = ap.parse_args(argv)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, args.workload)
    missing = None if args.rehearse else harness.card_missing(int(cell["chips"]))
    if missing:
        print(f"svbench.controls: {cell['name']} {missing}", file=sys.stderr)
        return 2
    controls = [c for c in args.controls.split(",") if c]
    faults = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.CellRun(cell, seed, rehearse=args.rehearse)
        try:
            t0 = time.time()
            run.setup()
            n = len(run.prepared)
            rec = run.window(0.0, False, min_passes=n)
            for mode in [None] + controls:
                checks, detail = run.check(rec, control=mode)
                _emit(seed, mode or "sound", checks, detail, rec, t0)
            del rec
            for fault in faults:
                rec = run.window(0.0, False, fault=fault, min_passes=n)
                checks, detail = run.check(rec)
                _emit(seed, f"fault:{fault}", checks, detail, rec, t0)
                del rec
        finally:
            run.close()
    return 0


def _emit(seed, mode, checks, detail, rec, t0) -> None:
    print(json.dumps({"seed": seed, "mode": mode, "numbers": {k: v["value"] for k, v in checks.items()},
                      "detail": detail, "passes": len(rec["passes"]),
                      "walls": [round(p["wall"], 3) for p in rec["passes"]],
                      "elapsed": round(time.time() - t0, 1)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
