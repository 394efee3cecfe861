"""Large-N specificity campaign through the port's Runner.

Port of ``tools/sweep_fp.py``: the same conditions, arguments and
record. It runs thousands of SV-free regions across the adversarial
condition grid

    repeats            repeat-rich genome + rmask BED
    repeats_poly       + het/hom germline SNPs and 1-6 bp indels,
                       no matched normal (every SNP mints novel k-mers)
    repeats_poly_deep  + 3x coverage (read_step 4 ~= 50x/strand)

under both operating profiles (``sweep_envelope.PROFILES``): ``default``,
the shipped thresholds, and ``tuned``, the marginal-sample knobs that
mint false positives. The record holds per-profile, per-condition FP
rates with Wilson 95% CIs, per-filter fire counts, and full detail for
every FP.

    python -m breakmer_tpu_torch.tools.sweep_fp [--seeds 170]
        [--profiles default tuned] [--out PATH] [--device cuda|cuda:N|cpu]

(170 seeds x 4 regions x 3 conditions = 2040 regions a profile.)
``--device`` (default ``cuda``; raises without a card unless ``cpu``) is
the Runner's device; the record goes to ``build/tools/ACCURACY_FP_r05.json``
unless ``--out`` names another path.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from collections import Counter
from pathlib import Path

from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.runner import Runner
from breakmer_tpu_torch.testing.fixtures import ErrorModel, GenomeModel, Polymorphism
from breakmer_tpu_torch.testing.scenarios import build_fp_scenario
from breakmer_tpu_torch.tools import default_out, write_json
from breakmer_tpu_torch.tools.sweep_accuracy import _collect_filters
from breakmer_tpu_torch.tools.sweep_envelope import PROFILES

CONDITIONS = {
    "repeats": dict(poly=False, read_step=12),
    "repeats_poly": dict(poly=True, read_step=12),
    "repeats_poly_deep": dict(poly=True, read_step=4),
}


def wilson_ci(k: int, n: int, z: float = 1.959964) -> tuple:
    """Wilson score 95% interval for a binomial proportion."""
    if n == 0:
        return (None, None)
    p = k / n
    z2 = z * z
    denom = 1 + z2 / n
    center = (p + z2 / (2 * n)) / denom
    half = z * ((p * (1 - p) / n + z2 / (4 * n * n)) ** 0.5) / denom
    return (round(max(0.0, center - half), 6),
            round(min(1.0, center + half), 6))


def run_campaign(profile: str, seeds: int, start_seed: int, t0: float,
                 device: str = "cuda"):
    overrides = PROFILES[profile]
    gm = GenomeModel()
    out = {}
    for cond, spec in CONDITIONS.items():
        poly = Polymorphism() if spec["poly"] else None
        filters: Counter = Counter()
        totals = {"prefilter_events": 0}
        n_regions = 0
        fps = []
        for i in range(seeds):
            # seed space disjoint from sweep_accuracy's FP panels (10_000+)
            seed = 20_000 + start_seed + i
            work = Path(tempfile.mkdtemp(prefix=f"fpc_{cond}_{seed}_"))
            try:
                cfg_kwargs = build_fp_scenario(
                    seed, work, n_genes=4, genome_model=gm,
                    polymorphism=poly, read_step=spec["read_step"],
                )
                cfg_kwargs.update(overrides)
                runner = Runner(Config(**cfg_kwargs, device=device))
                runner.setup()
                events = runner.run()
                _collect_filters(cfg_kwargs["analysis_dir"], filters, totals)
                n_regions += 4
                for e in events:
                    fps.append({
                        "profile": profile, "condition": cond, "seed": seed,
                        "gene": e.genes, "sv": f"{e.sv_type}/{e.sv_subtype}",
                        "size": e.size, "breakpoints": e.breakpoints_str(),
                        "sr": e.split_read_count,
                        "disc": e.disc_read_count,
                        "contig": e.contig_seq,
                    })
            finally:
                shutil.rmtree(work, ignore_errors=True)
            if (i + 1) % 25 == 0:
                print(f"[{profile}/{cond} {i+1}/{seeds}] regions={n_regions} "
                      f"fps={len(fps)} ({time.time()-t0:.0f}s)", flush=True)
        lo, hi = wilson_ci(len(fps), n_regions)
        out[cond] = {
            "regions": n_regions,
            "fp_calls": len(fps),
            "fp_rate_per_region": (round(len(fps) / n_regions, 6) if n_regions else None),
            "fp_rate_ci95": [lo, hi],
            "filters": {**totals, "fired": dict(filters.most_common())},
            "fp_detail": fps,
        }
        print(json.dumps({"profile": profile, "condition": cond, "regions": n_regions,
                          "fp": len(fps), "ci95": [lo, hi]}), flush=True)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m breakmer_tpu_torch.tools.sweep_fp")
    ap.add_argument("--seeds", type=int, default=170,
                    help="seeds per condition (x4 regions x3 conditions)")
    ap.add_argument("--start-seed", type=int, default=0)
    ap.add_argument("--profiles", nargs="+", default=["default", "tuned"],
                    choices=sorted(PROFILES))
    ap.add_argument("--out", default=default_out("ACCURACY_FP_r05.json"))
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from breakmer_tpu_torch.device import resolve

    args = parse_args(argv)
    resolve(args.device)  # raises without a card unless cpu
    t0 = time.time()
    per_profile = {}
    for profile in args.profiles:
        per_profile[profile] = run_campaign(profile, args.seeds, args.start_seed, t0,
                                            device=args.device)
    summary = {
        p: {
            "regions": sum(c["regions"] for c in conds.values()),
            "fp_calls": sum(c["fp_calls"] for c in conds.values()),
            "fp_rate_ci95": list(wilson_ci(
                sum(c["fp_calls"] for c in conds.values()),
                sum(c["regions"] for c in conds.values()))),
        }
        for p, conds in per_profile.items()
    }
    out = {
        "artifact": "large-N specificity campaign: SV-free regions across "
                    "repeats x polymorphism x deep coverage, default AND "
                    "tuned profiles, Wilson 95% CIs",
        "seeds_per_condition": args.seeds,
        "conditions": {k: dict(v) for k, v in CONDITIONS.items()},
        "profile_overrides": {p: PROFILES[p] for p in args.profiles},
        "error_model": ErrorModel().__dict__,
        "genome_model": GenomeModel().__dict__,
        "polymorphism": Polymorphism().__dict__,
        "summary": summary,
        "per_profile": per_profile,
        "wall_s": round(time.time() - t0, 1),
    }
    write_json(args.out, out)
    print(json.dumps({"summary": summary, "wall_s": out["wall_s"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
