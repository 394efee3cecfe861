"""Operating-envelope sweep through the port's Runner: recall against
coverage depth x error rate.

Port of ``tools/sweep_envelope.py``: the same grid, arguments and record.
It titrates both axes to find where the caller breaks:

  * coverage: junction-read tiling step 4..33 (~25x down to ~3x)
  * error rate: mean substitution rate 0.8% (Illumina-like), 2%, 4%

Every cell runs N random seeds of the 4-gene randomized panel (one SV
per gene, random kinds incl. trl) with the error model; recall is
per-SV-type planted-truth recovery under the property-test tolerances.

    python -m breakmer_tpu_torch.tools.sweep_envelope [--seeds 16]
        [--profile default|tuned] [--sub-rates 0.008,0.02] [--out PATH]
        [--device cuda|cuda:N|cpu]

``--device`` (default ``cuda``; raises without a card unless ``cpu``) is
the Runner's device; the record goes to ``build/tools/`` unless ``--out``
names another path.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from collections import defaultdict
from pathlib import Path

from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.runner import Runner
from breakmer_tpu_torch.testing.fixtures import ErrorModel
from breakmer_tpu_torch.testing.scenarios import build_scenario
from breakmer_tpu_torch.tools import default_out, write_json

READ_LEN = 100  # testing.fixtures.SamBuilder default
STEPS = [4, 8, 12, 16, 20, 25, 33]
SUB_RATES = [0.008, 0.02, 0.04]

# --profile tuned: the knobs the reference ships for marginal samples.
# At the 4% x 3x cliff cell, support/identity relaxation recovers ~10%
# absolute recall; min_kmer_count=1 and trim_qual=20 alone recover
# nothing: at ~7 junction reads with 4% errors the assembly k-mer
# overlap, not the thresholds, is the binding constraint.
PROFILES = {
    "default": {},
    "tuned": dict(min_kmer_count=1, trim_qual=20, indel_sr_thresh=1,
                  rearr_sr_thresh=1, trl_sr_thresh=1, min_identity=0.85),
}


def run_cell(step: int, sub_rate: float, seeds: int, start_seed: int,
             profile: str = "default", device: str = "cuda"):
    em = ErrorModel(sub_rate=sub_rate)
    stats = defaultdict(lambda: {"n": 0, "ok": 0})
    fails: list[str] = []
    for i in range(seeds):
        seed = start_seed + i
        work = Path(tempfile.mkdtemp(prefix=f"env{step}_{seed}_"))
        try:
            cfg_kwargs, checks = build_scenario(
                seed, work, n_genes=4, error_model=em, read_step=step,
            )
            cfg_kwargs.update(PROFILES[profile])
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
        k: {"n": v["n"], "ok": v["ok"], "recall": round(v["ok"] / v["n"], 4)}
        for k, v in sorted(stats.items())
    }
    tot_n = sum(v["n"] for v in stats.values())
    tot_ok = sum(v["ok"] for v in stats.values())
    return {
        "read_step": step,
        "junction_depth_x": round(READ_LEN / step, 1),
        "sub_rate": sub_rate,
        "recall_overall": round(tot_ok / tot_n, 4),
        "per_kind": per_kind,
        "failures_sample": fails[:6],
    }


def parse_args(argv=None):
    """The JAX tool's arguments and ``--device``; ``out`` filled in with
    its profile's default under ``build/tools/``."""
    ap = argparse.ArgumentParser(prog="python -m breakmer_tpu_torch.tools.sweep_envelope")
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--start-seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="default build/tools/ENVELOPE_r05.json, or "
                         "ENVELOPE_TUNED_r05.json with --profile tuned")
    ap.add_argument("--profile", choices=sorted(PROFILES), default="default")
    ap.add_argument("--sub-rates", default=None,
                    help="comma list overriding the error-rate axis "
                         "(tuned runs usually sweep only the cliff row)")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    if args.out is None:
        # a custom error-rate axis gets a name of its own
        base = "ENVELOPE_TUNED_r05" if args.profile == "tuned" else "ENVELOPE_r05"
        if args.sub_rates and args.profile != "tuned":
            base += "_CUSTOM"
        args.out = default_out(base + ".json")
    return args


def main(argv=None) -> int:
    from breakmer_tpu_torch.device import resolve

    args = parse_args(argv)
    resolve(args.device)  # raises without a card unless cpu
    sub_rates = ([float(x) for x in args.sub_rates.split(",")]
                 if args.sub_rates else SUB_RATES)

    t0 = time.time()
    cells = []
    for sub in sub_rates:
        for step in STEPS:
            cell = run_cell(step, sub, args.seeds, args.start_seed, args.profile,
                            device=args.device)
            cells.append(cell)
            print(
                f"step={step} (~{cell['junction_depth_x']}x) sub={sub}: "
                f"overall {cell['recall_overall']} "
                f"{ {k: v['recall'] for k, v in cell['per_kind'].items()} } "
                f"({time.time()-t0:.0f}s)",
                flush=True,
            )
    out = {
        "artifact": "operating envelope: recall vs junction depth x error rate",
        "seeds_per_cell": args.seeds,
        "read_len": READ_LEN,
        "profile": args.profile,
        "profile_overrides": PROFILES[args.profile],
        "grid": {"read_step": STEPS, "sub_rate": sub_rates},
        "cells": cells,
        "wall_s": round(time.time() - t0, 1),
    }
    write_json(args.out, out)
    print(f"wrote {args.out} ({time.time()-t0:.0f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
