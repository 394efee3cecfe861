"""The tandem "information floor" oracle through the port's Runner.

Port of ``tools/tandem_floor.py``: the same arguments and record. For
every failing gene of the repeats sweep it injects the true alt
haplotype (``testing.scenarios`` stashes it on each checker as
``check.alt_haps``) as a perfect contig, with no reads, assembly or
consensus errors, straight into realign + classify + filters (on the
Runner's device), and reruns the same planted-truth checker on the
result. Outcome classes a miss:

  floor        the checker still fails on the perfect contig's calls:
               the call cannot be expressed through alignment here
  recoverable  the checker passes: the loss happened upstream (read
               errors -> assembly/consensus)
  filtered     expressible by realign + call but killed by the filter
               stack (reasons recorded)

    python -m breakmer_tpu_torch.tools.tandem_floor [--seeds 400]
        [--start-seed 0] [--out PATH] [--device cuda|cuda:N|cpu]

``--device`` (default ``cuda``; raises without a card unless ``cpu``);
the record goes to ``build/tools/TANDEM_FLOOR_r05.json`` unless ``--out``
names another path.
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
from breakmer_tpu_torch.testing.fixtures import GenomeModel
from breakmer_tpu_torch.testing.scenarios import build_scenario
from breakmer_tpu_torch.tools import default_out, write_json
from breakmer_tpu_torch.tools.sweep_accuracy import _junction_context

READ_LEN = 100


def perfect_contigs(check, gene: str):
    """The true alt haplotype over the read-tiled window, as Contig
    objects with fabricated dense read tiling (support counts are not
    the question the oracle asks; expressibility is)."""
    from breakmer_tpu_torch.assemble.greedy import Contig, ContigRead

    out = []
    for ci, (hap, (w0, w1)) in enumerate(getattr(check, "alt_haps", [])):
        lo = max(0, w0)
        hi = min(len(hap.seq), w1 + READ_LEN)
        seq = hap.seq[lo:hi]
        reads = [
            ContigRead(name=f"oracle{ci}_{i}", index=i, offset=off,
                       length=min(READ_LEN, len(seq) - off))
            for i, off in enumerate(range(0, max(1, len(seq) - READ_LEN + 1), 4))
        ]
        out.append(Contig(id=f"{gene}_oracle{ci}", seq=seq, reads=reads, kmers=[]))
    return out


def run_oracle(runner: Runner, gene: str, check) -> tuple:
    """(outcome, detail): rerun realign+classify+filters on the perfect
    contigs, on the runner's device, and apply the planted-truth checker."""
    from breakmer_tpu_torch.align.realign import realign_contigs
    from breakmer_tpu_torch.call.events import classify_contig
    from breakmer_tpu_torch.call.filters import apply_filters
    from breakmer_tpu_torch.encode import encode_seq
    from breakmer_tpu_torch.pipeline import TargetPipeline, _dedup_identical

    cfg = runner.cfg
    target = runner.targets[gene]
    region_ref = runner.region_ref(target)
    pipe = TargetPipeline(cfg, target, region_ref, genome=runner.genome,
                          rmask=runner.rmask, device=runner.device)
    contigs = perfect_contigs(check, gene)
    if not contigs:
        return "no_oracle", {"note": "checker carries no alt_haps"}
    segs_per = realign_contigs(
        [(encode_seq(c.seq), region_ref) for c in contigs],
        genome=runner.genome, params=pipe.sw_params(), **pipe.realign_opts(),
        device=runner.device,
    )
    all_events = []
    for contig, segs in zip(contigs, segs_per):
        if segs:
            all_events.extend(classify_contig(contig, segs, gene, cfg,
                                              coverage_at=lambda c, p: 50))
    passed = apply_filters(all_events, cfg, rmask=runner.rmask, target=target)
    if cfg.dedup_identical_events:
        passed = _dedup_identical(passed)
    fails_filtered = check(passed)
    if not fails_filtered:
        return "recoverable", {"calls": [(e.sv_type, e.sv_subtype, e.size) for e in passed]}
    # expressible but filtered?
    fails_unfiltered = check(all_events)
    if not fails_unfiltered:
        reasons = [e.filter_reason for e in all_events if e.filter_reason]
        return "filtered", {"filter_reasons": reasons}
    return "floor", {
        "checker": fails_filtered[:2],
        "perfect_contig_calls": [
            (e.sv_type, e.sv_subtype, e.size, [bp[1] for bp in e.breakpoints])
            for e in all_events],
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m breakmer_tpu_torch.tools.tandem_floor")
    ap.add_argument("--seeds", type=int, default=400)
    ap.add_argument("--start-seed", type=int, default=0)
    ap.add_argument("--out", default=default_out("TANDEM_FLOOR_r05.json"))
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from breakmer_tpu_torch.device import resolve

    args = parse_args(argv)
    resolve(args.device)  # raises without a card unless cpu
    t0 = time.time()
    gm = GenomeModel()
    outcomes = defaultdict(Counter)  # context -> outcome counts
    misses = []
    n_checked = 0
    for i in range(args.seeds):
        seed = args.start_seed + i
        work = Path(tempfile.mkdtemp(prefix=f"floor{seed}_"))
        try:
            meta: dict = {}
            cfg_kwargs, checks = build_scenario(
                seed, work, n_genes=4, with_normal_germline=True,
                multi_sv_gene=True, genome_model=gm, meta_out=meta,
            )
            runner = Runner(Config(**cfg_kwargs, device=args.device))
            runner.setup()
            events = runner.run()
            rmask = runner.rmask
            for gene, (kind, check) in checks.items():
                if kind == "germline":
                    continue
                evs = [e for e in events if e.genes.split(",")[0] == gene]
                fails = check(evs)
                n_checked += 1
                if not fails:
                    continue
                ctx = _junction_context(meta.get("junction_mask_dist", {}).get(gene, []))
                outcome, detail = run_oracle(runner, gene, check)
                outcomes[ctx][outcome] += 1
                # the enclosing repeat feature's span: a tandem array
                # longer than the read length is a read-level floor
                feat_lens = []
                if rmask is not None:
                    for c, p in getattr(check, "junctions", []):
                        starts = rmask._starts.get(c)
                        if starts is None:
                            continue
                        ends = rmask._ends[c]
                        for s, e in zip(starts.tolist(), ends.tolist()):
                            if s - 25 <= p < e + 25:
                                feat_lens.append(e - s)
                misses.append({
                    "seed": seed, "gene": gene, "kind": kind,
                    "context": ctx, "outcome": outcome,
                    "junction_feature_span": max(feat_lens, default=None),
                    "pipeline_failure": fails[0][:200], **detail,
                })
        finally:
            shutil.rmtree(work, ignore_errors=True)
        if (i + 1) % 25 == 0:
            print(f"[{i+1}/{args.seeds}] misses={len(misses)} "
                  f"{dict((c, dict(o)) for c, o in outcomes.items())} "
                  f"({time.time()-t0:.0f}s)", flush=True)
    by_ctx = {
        ctx: {"total": sum(o.values()), **dict(o.most_common())}
        for ctx, o in sorted(outcomes.items())
    }
    out = {
        "artifact": "true-alt-haplotype oracle: every repeats-sweep miss "
                    "re-driven with a PERFECT contig through "
                    "realign+classify+filters — floor (inexpressible) vs "
                    "recoverable (assembly loss) vs filtered",
        "seeds": args.seeds,
        "start_seed": args.start_seed,
        "genome_model": gm.__dict__,
        "planted_checked": n_checked,
        "misses": len(misses),
        "outcomes_by_context": by_ctx,
        "miss_detail": misses,
        "wall_s": round(time.time() - t0, 1),
    }
    write_json(args.out, out)
    print(json.dumps({"outcomes_by_context": by_ctx, "wall_s": out["wall_s"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
