"""Triage one sweep seed through the port's Runner: rerun it and print
per-gene region stats, every prefilter event (with its filter_reason)
and the checker verdicts.

Port of ``tools/triage_scenario.py``, with the same arguments and the
same lines:

    python -m breakmer_tpu_torch.tools.triage_scenario SEED [--genome repeats]
        [--gene G3] [--kinds trl,ins,...] [--keep] [--device cuda|cuda:N|cpu]

``--device`` (default ``cuda``; raises without a card unless ``cpu``) is
the Runner's device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
from pathlib import Path

from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.runner import Runner
from breakmer_tpu_torch.testing.fixtures import GenomeModel
from breakmer_tpu_torch.testing.scenarios import build_scenario


def main(argv=None) -> int:
    from breakmer_tpu_torch.device import resolve

    ap = argparse.ArgumentParser(prog="python -m breakmer_tpu_torch.tools.triage_scenario")
    ap.add_argument("seed", type=int)
    ap.add_argument("--genome", choices=["uniform", "repeats"], default="repeats")
    ap.add_argument("--gene", default=None)
    ap.add_argument("--kinds", default=None, help="comma list forces per-gene SV kinds")
    ap.add_argument("--keep", action="store_true", help="keep the work dir (prints path)")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    resolve(args.device)  # raises without a card unless cpu

    work = Path(tempfile.mkdtemp(prefix=f"triage{args.seed}_"))
    gm = GenomeModel() if args.genome == "repeats" else None
    meta: dict = {}
    kinds = args.kinds.split(",") if args.kinds else None
    bs_kwargs = dict(genome_model=gm, meta_out=meta)
    if kinds:
        bs_kwargs["kinds"] = kinds
    else:
        bs_kwargs.update(with_normal_germline=True, multi_sv_gene=True)
    try:
        cfg_kwargs, checks = build_scenario(args.seed, work, n_genes=4, **bs_kwargs)
        cfg = Config(**{**cfg_kwargs, "keep_intermediates": True, "device": args.device})
        runner = Runner(cfg)
        runner.setup()
        events = runner.run()
        m = json.loads((work / "analysis" / "metrics.json").read_text())
        print("junction_mask_dist:", meta.get("junction_mask_dist"))
        for gene, (kind, check) in sorted(checks.items()):
            if args.gene and gene != args.gene:
                continue
            evs = [e for e in events if e.genes.split(",")[0] == gene]
            fails = check(evs)
            rs = m["regions"].get(gene, {})
            print(f"\n== {gene} [{kind}] {'FAIL' if fails else 'ok'}")
            print(f"   stats: {rs}")
            for f in fails:
                print(f"   fail: {f}")
            for res in runner.results:
                if res.target.name != gene:
                    continue
                for ev in res.all_events:
                    segs = [
                        (s.chrom, s.t_start, s.t_end, s.q_span,
                         round(getattr(s, 'repeat_frac', -1.0) or -1.0, 2))
                        for s in (ev.segments or [])
                    ]
                    print(f"   ev: {ev.sv_type}/{ev.sv_subtype} size={ev.size}"
                          f" bp={ev.breakpoints} sr={ev.split_read_count}"
                          f" filt={ev.filter_reason} segs={segs}")
                for c in res.contigs:
                    print(f"   contig len={len(c.seq)} reads={c.nreads} {c.seq[:70]}...")
    finally:
        if args.keep:
            print("\nwork dir kept:", work)
        else:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
