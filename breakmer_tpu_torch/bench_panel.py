"""End-to-end panel benchmark of the port (regions/s, reads/s, one host):

    python -m breakmer_tpu_torch.bench_panel [n_genes] [read_step] [nprocs] [--device D]
    python -m breakmer_tpu_torch.bench_panel --cpu-check | --cpu-update

Port of ``bench_panel.py``. Builds a deterministic synthetic panel
(default 20 genes, a planted insertion in every other gene), runs the
port's Runner on the batched path (``batch_regions=True``) twice, cold
and then warm (the second run of the process), and prints ONE JSON line:
regions/s of the warm run, with its reads/s, METER stage seconds, SW
batches and packed k-mer launches.

Against ``bench_panel.py``:
  - The device is explicit: ``--device`` (default ``cuda``) raises
    without a card, so no CPU number is printed under a card's metric.
    The line carries the card's name and power limit.
  - ``vs_baseline`` is gone and ``bench_panel_baseline.json`` is never
    written: it holds a TPU figure, which is no baseline of the port.
  - ``--cpu-check`` / ``--cpu-update`` gate the port's host path on the
    CPU against ``bench_panel_cpu_baseline.json`` beside this module. No
    commit holds that file: a machine records its own with
    ``--cpu-update``; without it ``--cpu-check`` exits 2.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

CPU_BASELINE = Path(__file__).with_name("bench_panel_cpu_baseline.json")


def build_panel(work: Path, n_genes: int, read_step: int, nprocs: int = 1,
                read_len: int = 100, device: str = "cuda"):
    """The panel of ``bench_panel.build_panel`` under ``work``, and its
    Config on ``device``."""
    from breakmer_tpu_torch.config import Config
    from breakmer_tpu_torch.io.fasta import write_fasta
    from breakmer_tpu_torch.testing.fixtures import (Haplotype, NovelBlock, RefBlock,
                                                     SamBuilder, rand_seq)

    span = 1200
    gap = 800
    chrom_len = n_genes * (span + gap) + 4000
    genome = {"chr1": rand_seq(1001, chrom_len)}
    write_fasta(work / "genome.fa", genome)
    sam = SamBuilder(genome)
    lines = []
    ins = "TTGACCATGGATCCGGTACAT"
    for g in range(n_genes):
        start = 2000 + g * (span + gap)
        end = start + span
        lines.append(f"chr1\t{start}\t{end}\tGENE{g}\n")
        if g % 2 == 0:
            mid = start + span // 2
            hap = Haplotype(genome, [
                RefBlock("chr1", start, mid), NovelBlock(ins),
                RefBlock("chr1", mid, end),
            ])
            sam.add_haplotype_reads(
                hap, span // 2 - 180, span // 2 + 160, step=read_step,
                read_len=read_len, prefix=f"g{g}r",
            )
        sam.add_background_pairs("chr1", start - 300, end + 300,
                                 step=read_step * 3, read_len=read_len,
                                 prefix=f"bg{g}")
    (work / "targets.bed").write_text("".join(lines))
    sam.write(work / "sample.sam")
    return Config(
        analysis_name="panelbench",
        analysis_dir=str(work / "analysis"),
        targets_bed_file=str(work / "targets.bed"),
        reference_fasta=str(work / "genome.fa"),
        reference_data_dir=str(work / "refdata"),
        sample_bam_file=str(work / "sample.sam"),
        indel_sr_thresh=2,
        batch_regions=True,
        nprocs=nprocs,
        device=device,
        log_level="WARNING",
    )


def run_once(cfg) -> dict:
    """One Runner setup + run on a copy of ``cfg``; wall seconds (after
    the card finished) and what the run counted."""
    import torch

    from breakmer_tpu_torch.runner import Runner
    from breakmer_tpu_torch.utils.meter import METER

    t0 = time.perf_counter()
    runner = Runner(type(cfg)(**{**cfg.__dict__}))
    runner.setup()
    runner.run()
    if runner.device.type == "cuda":
        torch.cuda.synchronize(runner.device)
    dt = time.perf_counter() - t0
    snap = METER.snapshot()
    return {
        "elapsed_s": dt,
        "targets": len(runner.targets),
        "calls": runner.total_calls,
        "records": sum(r.n_records for r in runner.results),
        "stage_s": snap["stage_s"],
        "sw_batches": snap.get("sw", {}).get("launches", 0),
        "kmer_launches": runner.kmer_pipeline.dispatched,
        "kmer_refetches": runner.kmer_pipeline.refetched,
    }


def cpu_check(update: bool = False, warm_runs: int = 3) -> int:
    """--cpu-check: warm CPU panel throughput at 20/100 genes (median of
    ``warm_runs`` warm runs each) against ``bench_panel_cpu_baseline.json``;
    exit 1 when any shape is more than 25% below it, 2 when the file is
    missing. --cpu-update rewrites the file. Run it on an otherwise idle
    host: concurrent work skews host wall times."""
    results = {}
    for n_genes in (20, 100):
        work = Path(tempfile.mkdtemp(prefix="breakmer_torch_cpuchk_"))
        try:
            cfg = build_panel(work, n_genes, 6, device="cpu")
            cold = run_once(cfg)
            warms = []
            for _ in range(max(1, warm_runs)):
                shutil.rmtree(cfg.analysis_dir, ignore_errors=True)
                warms.append(run_once(cfg))
            times = sorted(w["elapsed_s"] for w in warms)
            med = times[len(times) // 2]
            results[f"{n_genes}g"] = {
                "regions_per_s": warms[0]["targets"] / med,
                "warm_s": med,
                "warm_s_all": times,
                "cold_s": cold["elapsed_s"],
                "calls": warms[0]["calls"],
            }
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if update:
        CPU_BASELINE.write_text(json.dumps(results, indent=1) + "\n")
        print(json.dumps({"cpu_check": results, "baseline": "written"}))
        return 0
    if not CPU_BASELINE.exists():
        # a gate that silently self-baselines is no gate
        print(json.dumps({
            "cpu_check": results, "ok": False,
            "error": f"{CPU_BASELINE.name} missing: run --cpu-update on a "
                     "known-good idle host first",
        }))
        return 2
    base = json.loads(CPU_BASELINE.read_text())
    drift = {k: results[k]["regions_per_s"] / base[k]["regions_per_s"]
             for k in results if k in base}
    # a key-mismatched baseline must not pass vacuously
    ok = bool(drift) and set(results) <= set(base) and all(
        d >= 0.75 for d in drift.values())
    print(json.dumps({"cpu_check": results, "drift_vs_baseline": drift, "ok": ok}))
    return 0 if ok else 1


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m breakmer_tpu_torch.bench_panel")
    p.add_argument("n_genes", nargs="?", type=int, default=20)
    p.add_argument("read_step", nargs="?", type=int, default=6)
    p.add_argument("nprocs", nargs="?", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    p.add_argument("--cpu-check", action="store_true")
    p.add_argument("--cpu-update", action="store_true")
    args = p.parse_args(argv)
    if args.cpu_check or args.cpu_update:
        raise SystemExit(cpu_check(update=args.cpu_update))

    import torch

    from breakmer_tpu_torch.device import resolve

    device = resolve(args.device)  # raises without a card unless cpu
    on_card = device.type == "cuda"
    work = Path(tempfile.mkdtemp(prefix="breakmer_torch_panel_"))
    try:
        cfg = build_panel(work, args.n_genes, args.read_step, args.nprocs,
                          device=str(device))
        cold = run_once(cfg)
        shutil.rmtree(cfg.analysis_dir, ignore_errors=True)
        warm = run_once(cfg)
        line = {
            "metric": "panel_regions_per_s",
            "value": warm["targets"] / warm["elapsed_s"],
            "unit": "regions/s",
            "platform": "gpu" if on_card else "cpu",
            "device": torch.cuda.get_device_name(device) if on_card else "cpu",
            "detail": {
                "n_genes": args.n_genes,
                "read_step": args.read_step,
                "nprocs": args.nprocs,
                "calls": warm["calls"],
                "records": warm["records"],
                "reads_per_s": warm["records"] / warm["elapsed_s"],
                "cold_s": cold["elapsed_s"],
                "warm_s": warm["elapsed_s"],
                "stage_s": warm["stage_s"],
                "sw_batches": warm["sw_batches"],
                "kmer_launches": warm["kmer_launches"],
                "kmer_refetches": warm["kmer_refetches"],
            },
        }
        if on_card:
            from breakmer_tpu_torch.timing import card_line

            line["card"] = card_line()
        print(json.dumps(line))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
