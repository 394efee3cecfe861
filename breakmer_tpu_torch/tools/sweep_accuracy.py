"""Reproducible accuracy sweep through the port's Runner on ``--device``.

Port of ``tools/sweep_accuracy.py``: the same arguments and the same
record. It runs the port's Runner over N randomized planted-SV panels
with the sequencing-error model on (``testing.scenarios.build_scenario``:
every seed carries 3 random-kind SVs, one two-SV region, and a
matched-normal germline-subtraction scenario), plus M SV-free noisy
panels for the false-positive operating point of the filter stack.

``--genome repeats`` swaps the uniform-random background for the
repeat-rich GenomeModel (tandem repeats, homopolymers, a dispersed Alu
analog family, low-complexity runs) and wires its ground-truth rmask BED
into the run; the record then also reports the planted-junction repeat
context. Every run's metrics.json filter_reasons are aggregated into a
``filters`` section (per-reason fire counts, recall panels and FP panels
apart).

    python -m breakmer_tpu_torch.tools.sweep_accuracy [--seeds 200] [--fp 50]
        [--genome uniform|repeats] [--extremes] [--polymorphism]
        [--start-seed 0] [--out PATH] [--device cuda|cuda:N|cpu]

Against the JAX tool: ``--device`` (default ``cuda``; raises without a
card unless ``cpu``) is the Runner's device, and the record goes to
``build/tools/<the JAX tool's default name>`` unless ``--out`` says
otherwise. On the same seeds the record equals the JAX tool's apart
from ``wall_s``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from collections import Counter, defaultdict
from pathlib import Path

from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.runner import Runner
from breakmer_tpu_torch.testing.fixtures import ErrorModel, GenomeModel, Polymorphism
from breakmer_tpu_torch.testing.scenarios import build_fp_scenario, build_scenario
from breakmer_tpu_torch.tools import default_out, write_json


def _collect_filters(analysis_dir: str, counter: Counter, totals: dict) -> None:
    """Aggregate per-region filter_reason fire counts from metrics.json
    (reason key = text before the first ':', e.g. 'repeat_overlap')."""
    mpath = Path(analysis_dir) / "metrics.json"
    if not mpath.exists():
        return
    m = json.loads(mpath.read_text())
    for stats in m.get("regions", {}).values():
        totals["prefilter_events"] += stats.get("prefilter_events", 0)
        for reason in stats.get("filter_reasons", []):
            counter[str(reason).split(":", 1)[0]] += 1


_CTX_PRIORITY = ["tandem", "homopoly", "lowcomp", "alu"]


def _junction_context(dists) -> str:
    """Classify a gene's planted-junction context from (dist, kind)
    pairs: the highest-priority feature kind any junction sits in (or
    within 25 bp of, for slippage-prone tandem/homopolymer), else
    'unique'. Per-kind recall names the failure mechanism: tandem =
    VNTR slippage absorption, lowcomp = complexity-filter rejection
    (by design), alu = multi-mapping misinterpretation."""
    best = None
    for d, kind in dists:
        if d is None:
            continue
        near = d <= 25 if kind in ("tandem", "homopoly") else d == 0
        if near and (best is None
                     or _CTX_PRIORITY.index(kind) < _CTX_PRIORITY.index(best)):
            best = kind
    return best or "unique"


def run_recall_seed(seed: int, stats, failures, error_model=None,
                    genome_model=None, filt=None, jn_stats=None,
                    ctx_stats=None, polymorphism=None, device: str = "cuda") -> None:
    work = Path(tempfile.mkdtemp(prefix=f"sweep{seed}_"))
    try:
        kw = {} if error_model is None else {"error_model": error_model}
        if polymorphism is not None:
            kw["polymorphism"] = polymorphism
        meta: dict = {}
        cfg_kwargs, checks = build_scenario(
            seed, work, n_genes=4, with_normal_germline=True,
            multi_sv_gene=True, genome_model=genome_model, meta_out=meta,
            **kw,
        )
        runner = Runner(Config(**cfg_kwargs, device=device))
        runner.setup()
        events = runner.run()
        if filt is not None:
            _collect_filters(cfg_kwargs["analysis_dir"], *filt)
        if jn_stats is not None:
            for dists in meta.get("junction_mask_dist", {}).values():
                for d, kind in dists:
                    if d is None:
                        continue
                    jn_stats["n"] += 1
                    if d == 0:
                        jn_stats["inside"] += 1
                        jn_stats.setdefault("inside_by_kind", Counter())[kind] += 1
                    if d <= 50:
                        jn_stats["within_50bp"] += 1
        for gene, (kind, check) in checks.items():
            evs = [e for e in events if e.genes.split(",")[0] == gene]
            fails = check(evs)
            stats[kind]["n"] += 1
            ctx = _junction_context(meta.get("junction_mask_dist", {}).get(gene, []))
            if ctx_stats is not None:
                ctx_stats[ctx]["n"] += 1
            if fails:
                stats[kind]["fail"] += 1
                failures.extend(f"seed {seed} {gene} [{ctx}]: {f}" for f in fails)
            else:
                stats[kind]["ok"] += 1
                if ctx_stats is not None:
                    ctx_stats[ctx]["ok"] += 1
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_fp_seed(seed: int, fp_stats, fp_details, error_model=None,
                genome_model=None, filt=None, polymorphism=None,
                device: str = "cuda") -> None:
    work = Path(tempfile.mkdtemp(prefix=f"fp{seed}_"))
    try:
        kw = {} if error_model is None else {"error_model": error_model}
        if polymorphism is not None:
            kw["polymorphism"] = polymorphism
        cfg_kwargs = build_fp_scenario(seed, work, n_genes=4,
                                       genome_model=genome_model, **kw)
        runner = Runner(Config(**cfg_kwargs, device=device))
        runner.setup()
        events = runner.run()
        if filt is not None:
            _collect_filters(cfg_kwargs["analysis_dir"], *filt)
        fp_stats["regions"] += 4
        fp_stats["calls"] += len(events)
        genes_hit = {e.genes for e in events}
        fp_stats["regions_with_calls"] += len(genes_hit)
        for e in events:
            fp_details.append(
                f"seed {seed} {e.genes}: {e.sv_type}/{e.sv_subtype} "
                f"size {e.size} at {e.breakpoints_str()} "
                f"(sr={e.split_read_count})"
            )
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_extremes(args, stats, failures, error_model, t0,
                 genome_model=None, polymorphism=None) -> int:
    """--extremes: per-kind recall over the wide-region extreme panel
    (``testing.scenarios.build_extremes_scenario``), combinable with
    --genome repeats / --polymorphism."""
    from breakmer_tpu_torch.testing.scenarios import build_extremes_scenario

    ctx_stats = defaultdict(lambda: {"n": 0, "ok": 0})
    for i in range(args.seeds):
        seed = args.start_seed + i
        work = Path(tempfile.mkdtemp(prefix=f"ext{seed}_"))
        try:
            kw = {} if error_model is None else {"error_model": error_model}
            meta: dict = {}
            cfg_kwargs, checks = build_extremes_scenario(
                seed, work, genome_model=genome_model,
                polymorphism=polymorphism, meta_out=meta, **kw)
            runner = Runner(Config(**cfg_kwargs, device=args.device))
            runner.setup()
            events = runner.run()
            for gene, (kind, check) in checks.items():
                evs = [e for e in events if e.genes.split(",")[0] == gene]
                fails = check(evs)
                stats[kind]["n"] += 1
                ctx = _junction_context(meta.get("junction_mask_dist", {}).get(gene, []))
                ctx_stats[ctx]["n"] += 1
                if fails:
                    stats[kind]["fail"] += 1
                    failures.extend(f"seed {seed} {gene} [{ctx}]: {f}" for f in fails)
                else:
                    stats[kind]["ok"] += 1
                    ctx_stats[ctx]["ok"] += 1
        finally:
            shutil.rmtree(work, ignore_errors=True)
        if (i + 1) % 10 == 0:
            done = {k: f"{v['ok']}/{v['n']}" for k, v in sorted(stats.items())}
            print(f"[{i+1}/{args.seeds}] {done} ({time.time()-t0:.0f}s)", flush=True)
    recall = {
        kind: {"n": v["n"], "ok": v["ok"], "fail": v["fail"],
               "recall": round(v["ok"] / v["n"], 4) if v["n"] else None}
        for kind, v in sorted(stats.items())
    }
    out = {
        "artifact": "extreme-SV sweep (size boundaries, multi-kb events, "
                    "reciprocal trl + BND MATEID consistency"
                    + (", repeat-rich genome" if genome_model else "")
                    + (", germline polymorphism" if polymorphism else "")
                    + ")",
        "seeds": args.seeds,
        "start_seed": args.start_seed,
        "genome_model": genome_model.__dict__ if genome_model else None,
        "polymorphism": polymorphism.__dict__ if polymorphism else None,
        "error_model": (error_model or ErrorModel()).__dict__,
        "recall": recall,
        "failures_sample": failures[:25],
        "wall_s": round(time.time() - t0, 1),
    }
    if genome_model is not None:
        out["recall_by_context"] = {
            ctx: {"n": v["n"], "ok": v["ok"],
                  "recall": round(v["ok"] / v["n"], 4) if v["n"] else None}
            for ctx, v in sorted(ctx_stats.items())
        }
    write_json(args.out, out)
    print(json.dumps({"recall": recall, "wall_s": out["wall_s"]}))
    return 0 if sum(v["fail"] for v in stats.values()) == 0 else 1


def _error_model_overrides(args) -> dict:
    return {k: v for k, v in (
        ("sub_rate", args.sub_rate), ("indel_rate", args.indel_rate),
        ("q_start", args.q_start), ("q_end", args.q_end),
        ("miscalibrated", args.miscalibrated),
    ) if v is not None}


def parse_args(argv=None):
    """The JAX tool's arguments and ``--device``; ``out`` filled in with
    its mode's default under ``build/tools/``."""
    ap = argparse.ArgumentParser(prog="python -m breakmer_tpu_torch.tools.sweep_accuracy")
    ap.add_argument("--seeds", type=int, default=200)
    ap.add_argument("--fp", type=int, default=50)
    ap.add_argument("--start-seed", type=int, default=0)
    ap.add_argument("--genome", choices=["uniform", "repeats"], default="uniform")
    ap.add_argument("--extremes", action="store_true",
                    help="run the EXTREME_KINDS panel instead (size "
                         "boundaries, multi-kb events, reciprocal trl)")
    ap.add_argument("--polymorphism", action="store_true",
                    help="benign germline het/hom SNPs + 1-6bp indels in "
                         "the sample (no matched normal on FP panels)")
    ap.add_argument("--out", default=None,
                    help="record path; default build/tools/ACCURACY_<mode>_r05.json")
    ap.add_argument("--sub-rate", type=float, default=None,
                    help="override ErrorModel.sub_rate (stress runs)")
    ap.add_argument("--indel-rate", type=float, default=None)
    ap.add_argument("--q-start", type=int, default=None)
    ap.add_argument("--q-end", type=int, default=None)
    ap.add_argument("--miscalibrated", type=float, default=None)
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    if args.out is None:
        parts = (["EXTREMES"] if args.extremes else []) + (
            ["REPEATS"] if args.genome == "repeats" else []) + (
            ["POLY"] if args.polymorphism else []) + (
            ["STRESS"] if _error_model_overrides(args) else [])
        tag = "_".join(parts) or None
        args.out = default_out(f"ACCURACY_{tag}_r05.json" if tag else "ACCURACY_r05.json")
    return args


def main(argv=None) -> int:
    from breakmer_tpu_torch.device import resolve

    args = parse_args(argv)
    resolve(args.device)  # raises without a card unless cpu
    em_kw = _error_model_overrides(args)
    error_model = ErrorModel(**em_kw) if em_kw else None
    genome_model = GenomeModel() if args.genome == "repeats" else None
    poly = Polymorphism() if args.polymorphism else None

    t0 = time.time()
    stats = defaultdict(lambda: {"n": 0, "ok": 0, "fail": 0})
    failures: list[str] = []
    if args.extremes:
        return run_extremes(args, stats, failures, error_model, t0,
                            genome_model=genome_model, polymorphism=poly)
    recall_filters: Counter = Counter()
    recall_totals = {"prefilter_events": 0}
    jn_stats = {"n": 0, "inside": 0, "within_50bp": 0}
    ctx_stats = defaultdict(lambda: {"n": 0, "ok": 0})
    for i in range(args.seeds):
        seed = args.start_seed + i
        run_recall_seed(seed, stats, failures, error_model, genome_model,
                        (recall_filters, recall_totals), jn_stats, ctx_stats,
                        poly, device=args.device)
        if (i + 1) % 20 == 0:
            done = {k: f"{v['ok']}/{v['n']}" for k, v in sorted(stats.items())}
            print(f"[{i+1}/{args.seeds}] {done} ({time.time()-t0:.0f}s)", flush=True)

    fp_stats = {"regions": 0, "calls": 0, "regions_with_calls": 0}
    fp_details: list[str] = []
    fp_filters: Counter = Counter()
    fp_totals = {"prefilter_events": 0}
    for i in range(args.fp):
        run_fp_seed(10_000 + args.start_seed + i, fp_stats, fp_details,
                    error_model, genome_model, (fp_filters, fp_totals), poly,
                    device=args.device)
        if (i + 1) % 20 == 0:
            print(f"[fp {i+1}/{args.fp}] {fp_stats} ({time.time()-t0:.0f}s)", flush=True)

    recall = {
        kind: {
            "n": v["n"], "ok": v["ok"], "fail": v["fail"],
            "recall": round(v["ok"] / v["n"], 4) if v["n"] else None,
        }
        for kind, v in sorted(stats.items())
    }
    out = {
        "artifact": (f"accuracy sweep (noisy reads, {args.genome} genome"
                     + (", germline polymorphism" if poly else "") + ")"),
        "seeds": args.seeds,
        "start_seed": args.start_seed,
        "genome": args.genome,
        "genome_model": genome_model.__dict__ if genome_model else None,
        "polymorphism": poly.__dict__ if poly else None,
        "error_model": (error_model or ErrorModel()).__dict__,
        "recall": recall,
        "fp": {
            **fp_stats,
            "fp_rate_per_region": (
                round(fp_stats["calls"] / fp_stats["regions"], 4)
                if fp_stats["regions"] else None
            ),
        },
        "filters": {
            "recall_panels": {**recall_totals, "fired": dict(recall_filters.most_common())},
            "fp_panels": {**fp_totals, "fired": dict(fp_filters.most_common())},
        },
        "failures_sample": failures[:25],
        "fp_sample": fp_details[:25],
        "wall_s": round(time.time() - t0, 1),
    }
    if genome_model is not None:
        # recall split by planted-junction context: 'tandem' misses are
        # the VNTR slippage-absorption envelope, not caller defects
        out["recall_by_context"] = {
            ctx: {"n": v["n"], "ok": v["ok"],
                  "recall": round(v["ok"] / v["n"], 4) if v["n"] else None}
            for ctx, v in sorted(ctx_stats.items())
        }
        out["junction_repeat_context"] = {
            **jn_stats,
            "frac_inside": (round(jn_stats["inside"] / jn_stats["n"], 4)
                            if jn_stats["n"] else None),
            "frac_within_50bp": (round(jn_stats["within_50bp"] / jn_stats["n"], 4)
                                 if jn_stats["n"] else None),
        }
    write_json(args.out, out)
    print(json.dumps({k: out[k] for k in ("recall", "fp", "wall_s")}))
    n_fail = sum(v["fail"] for v in stats.values())
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
