"""VAF (tumour-purity) titration envelope through the port's Runner.

Port of ``tools/sweep_envelope_vaf.py``: the same grid, arguments and
record. It holds total junction depth fixed and dilutes the alt
haplotype with reference-haplotype reads over the same window
(``testing.scenarios.plant_sv(vaf=)``), mapping the minimum detectable
VAF a SV type:

  * vaf   in {0.5, 0.25, 0.1, 0.05}
  * depth in {100x, 250x} total junction coverage (read_step 1.0 / 0.4)

Every cell runs N random seeds of the 4-gene randomized panel with the
error model; the boundary cells are powered with fixed-kind panels.

    python -m breakmer_tpu_torch.tools.sweep_envelope_vaf [--seeds 12]
        [--boundary-per-kind 52] [--out PATH] [--device cuda|cuda:N|cpu]

``--device`` (default ``cuda``; raises without a card unless ``cpu``);
the record goes to ``build/tools/ENVELOPE_VAF_r05.json`` unless ``--out``
names another path.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from collections import defaultdict
from pathlib import Path

from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.runner import Runner
from breakmer_tpu_torch.testing.scenarios import build_scenario
from breakmer_tpu_torch.tools import default_out, write_json

READ_LEN = 100
VAFS = [0.5, 0.25, 0.1, 0.05]
DEPTHS = [100, 250]
# detection-boundary cells get >= 50 events a SV kind a cell
BOUNDARY_CELLS = [(0.05, 100), (0.05, 250), (0.025, 250)]
SV_KINDS = ["ins", "del", "dup", "inv", "trl"]


def wilson_ci(k: int, n: int, z: float = 1.959964) -> list:
    if n == 0:
        return [None, None]
    p = k / n
    z2 = z * z
    denom = 1 + z2 / n
    center = (p + z2 / (2 * n)) / denom
    half = z * ((p * (1 - p) / n + z2 / (4 * n * n)) ** 0.5) / denom
    return [round(max(0.0, center - half), 4),
            round(min(1.0, center + half), 4)]


def run_cell(vaf: float, depth: int, seeds: int, start_seed: int,
             kinds=None, device: str = "cuda"):
    step = READ_LEN / depth
    stats = defaultdict(lambda: {"n": 0, "ok": 0})
    fails: list[str] = []
    for i in range(seeds):
        seed = start_seed + i
        work = Path(tempfile.mkdtemp(prefix=f"vaf{depth}_{seed}_"))
        try:
            cfg_kwargs, checks = build_scenario(
                seed, work, n_genes=4, read_step=step, vaf=vaf, kinds=kinds,
            )
            runner = Runner(Config(**cfg_kwargs, device=device))
            runner.setup()
            events = runner.run()
            for gene, (kind, check) in checks.items():
                evs = [e for e in events if e.genes.split(",")[0] == gene]
                f = check(evs)
                stats[kind]["n"] += 1
                if f:
                    fails.extend(f"seed {seed} {gene}: {x}" for x in f)
                else:
                    stats[kind]["ok"] += 1
        finally:
            shutil.rmtree(work, ignore_errors=True)
    per_kind = {
        k: {"n": v["n"], "ok": v["ok"],
            "recall": round(v["ok"] / v["n"], 4),
            "recall_ci95": wilson_ci(v["ok"], v["n"])}
        for k, v in sorted(stats.items())
    }
    tot_n = sum(v["n"] for v in stats.values())
    tot_ok = sum(v["ok"] for v in stats.values())
    return {
        "vaf": vaf,
        "depth": depth,
        "alt_reads_at_junction": round(depth * vaf, 1),
        "recall": round(tot_ok / tot_n, 4) if tot_n else None,
        "per_kind": per_kind,
        "failures_sample": fails[:6],
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m breakmer_tpu_torch.tools.sweep_envelope_vaf")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--boundary-per-kind", type=int, default=52,
                    help="min events per SV kind at each BOUNDARY_CELLS "
                         "entry (planted as fixed-kind panels)")
    ap.add_argument("--start-seed", type=int, default=0)
    ap.add_argument("--out", default=default_out("ENVELOPE_VAF_r05.json"))
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from breakmer_tpu_torch.device import resolve

    args = parse_args(argv)
    resolve(args.device)  # raises without a card unless cpu
    t0 = time.time()
    cells = []
    for depth in DEPTHS:
        for vaf in VAFS:
            cell = run_cell(vaf, depth, args.seeds, args.start_seed, device=args.device)
            cell["wall_s"] = round(time.time() - t0, 1)
            cells.append(cell)
            print(json.dumps({k: cell[k] for k in ("vaf", "depth", "recall")}), flush=True)
    # ---- powered boundary cells: fixed-kind panels, n>=50 per kind ----
    boundary = []
    n_seeds = (args.boundary_per_kind + 3) // 4  # 4 same-kind genes a seed
    for vaf, depth in BOUNDARY_CELLS:
        merged = {"vaf": vaf, "depth": depth,
                  "alt_reads_at_junction": round(depth * vaf, 1),
                  "per_kind": {}, "failures_sample": []}
        for kind in SV_KINDS:
            cell = run_cell(vaf, depth, n_seeds, args.start_seed + 500,
                            kinds=[kind] * 4, device=args.device)
            merged["per_kind"].update(cell["per_kind"])
            merged["failures_sample"].extend(cell["failures_sample"][:2])
        ns = [v["n"] for v in merged["per_kind"].values()]
        oks = [v["ok"] for v in merged["per_kind"].values()]
        merged["recall"] = round(sum(oks) / sum(ns), 4)
        merged["wall_s"] = round(time.time() - t0, 1)
        boundary.append(merged)
        print(json.dumps({"boundary": [vaf, depth], "recall": merged["recall"],
                          "per_kind": {k: v["recall"] for k, v in merged["per_kind"].items()}}),
              flush=True)
    # minimum VAF with recall >= 0.9 a kind a depth; boundary cells
    # (powered, n>=50 a kind) override the thin random-kind grid cells
    min_vaf = {}
    for depth in DEPTHS:
        by_kind = defaultdict(dict)
        for c in cells + boundary:
            if c["depth"] != depth:
                continue
            for k, v in c["per_kind"].items():
                by_kind[k][c["vaf"]] = v["recall"]
        min_vaf[f"{depth}x"] = {
            k: min((vaf for vaf, r in vr.items() if r >= 0.9), default=None)
            for k, vr in sorted(by_kind.items())
        }
    out = {
        "artifact": "VAF titration envelope (total junction depth fixed; "
                    "alt fraction diluted by reference-haplotype reads); "
                    "boundary cells powered to >=50 events/kind with "
                    "Wilson CIs",
        "seeds_per_cell": args.seeds,
        "boundary_events_per_kind": n_seeds * 4,
        "grid": {"vaf": VAFS, "depth": DEPTHS},
        "cells": cells,
        "boundary_cells": boundary,
        "min_detectable_vaf_recall90": min_vaf,
        "wall_s": round(time.time() - t0, 1),
    }
    write_json(args.out, out)
    print(json.dumps({"min_detectable_vaf_recall90": min_vaf}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
