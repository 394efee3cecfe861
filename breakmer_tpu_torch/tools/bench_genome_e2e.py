"""Genome-scale end-to-end check of the port: its Runner against a
synthetic >= 85 Mbp reference with planted SVs.

Port of ``tools/bench_genome_e2e.py``, with the same fixture (three
chromosomes in a hg-like ratio; four targets at chr1 10-40 Mb; an
insertion, a deletion and a chr1->chr3 translocation planted), the same
timing wrappers around ``GenomeIndex.save`` / ``load`` (the index
artifact inside ``Runner.setup``), ``batch_regions=True`` and the same
JSON line: FASTA indexing, the runner's streaming GenomeIndex build, the
index cache's save and warm reload, genome-pass realignment against a
real-size seed table, and the planted calls.

    python -m breakmer_tpu_torch.tools.bench_genome_e2e [total_bp] [--device cuda]

Default 100e6 bp. Against the JAX tool, which forces the CPU: the Runner
runs on ``--device`` (default ``cuda``; raises without a card unless
``cpu``). Before anything else it prints the host's RAM (MemTotal and
MemAvailable of /proc/meminfo); where MemAvailable cannot hold the run
(about ``BYTES_PER_BP`` a base at peak) it cuts ``total_bp`` to fit and
says so in the JSON (``"reduced"``). Then the card's name and power
limit on a card; the JSON line comes last.
"""

from __future__ import annotations

import argparse
import gc
import json
import resource
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from breakmer_tpu_torch.align.index import GenomeIndex
from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.runner import Runner
from breakmer_tpu_torch.testing.fixtures import Haplotype, NovelBlock, RefBlock, SamBuilder

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
FLOOR_BP = 85_000_000  # the targets sit at fixed chr1:10M..40M offsets (chr1 is total/2)
# peak RSS a base of the genome: 15.9 GB at 3.1 Gbp for the JAX tool
# (GENOME_E2E_r05.json), 5.1 bytes a base, with room to spare
BYTES_PER_BP = 6.0
INS = "TTGACCATGGATCCGGTACAT"


def meminfo_mb() -> dict:
    """MemTotal and MemAvailable of /proc/meminfo, in MB."""
    out = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, _, rest = line.partition(":")
        if key in ("MemTotal", "MemAvailable"):
            out[key] = int(rest.split()[0]) / 1024
    return out


def _vm_rss_mb() -> float:
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1024
    return 0.0


def rand_chrom(seed: int, n: int) -> str:
    # uint8 draws: the default int64 would transiently cost 8 bytes/bp
    rng = np.random.default_rng(seed)
    return _BASES[rng.integers(0, 4, n, dtype=np.uint8)].tobytes().decode()


def build_fixture(work: Path, total: int) -> dict:
    """genome.fa, targets.bed and sample.sam under ``work``; returns the
    Config keys of the run and the FASTA's write seconds."""
    n1, n2, n3 = int(total * 0.5), int(total * 0.3), int(total * 0.2)
    genome = {
        "chr1": rand_chrom(11, n1),
        "chr2": rand_chrom(22, n2),
        "chr3": rand_chrom(33, n3),
    }
    t0 = time.time()
    fa = work / "genome.fa"
    with open(fa, "w") as fh:
        for name, seq in genome.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 10_000_000):
                fh.write(seq[i:i + 10_000_000] + "\n")
    write_s = time.time() - t0

    # 4 targets deep inside chr1; an insertion, a deletion and a
    # chr1->chr3 translocation (the genome realignment pass must place
    # the partner segment through the full-genome seed index)
    targets = [
        ("chr1", 10_000_000, 10_001_200, "G_INS"),
        ("chr1", 20_000_000, 20_001_200, "G_DEL"),
        ("chr1", 30_000_000, 30_001_200, "G_TRL"),
        ("chr1", 40_000_000, 40_001_200, "G_REF"),
    ]
    with open(work / "targets.bed", "w") as fh:
        for c, s, e, g in targets:
            fh.write(f"{c}\t{s}\t{e}\t{g}\n")
    sam = SamBuilder(genome)
    sam.add_haplotype_reads(Haplotype(genome, [
        RefBlock("chr1", 10_000_000, 10_000_600), NovelBlock(INS),
        RefBlock("chr1", 10_000_600, 10_001_200),
    ]), 180, 820, prefix="ins")
    sam.add_haplotype_reads(Haplotype(genome, [
        RefBlock("chr1", 20_000_000, 20_000_500),
        RefBlock("chr1", 20_000_560, 20_001_200),
    ]), 180, 1000, prefix="dele")
    sam.add_haplotype_reads(Haplotype(genome, [
        RefBlock("chr1", 30_000_000, 30_000_600),
        RefBlock("chr3", 5_000_000, 5_000_500),
    ]), 180, 820, prefix="trl")
    sam.add_discordant_pairs("chr1", 30_000_600, "chr3", 5_000_000, n=5)
    for c, s, e, g in targets:
        sam.add_background_pairs(c, s - 200, e + 200, prefix=f"bg{g}")
    sam.write(work / "sample.sam")
    base = dict(
        analysis_name="genome_e2e",
        targets_bed_file=str(work / "targets.bed"),
        reference_fasta=str(fa),
        reference_data_dir=str(work / "refdata"),
        sample_bam_file=str(work / "sample.sam"),
        indel_sr_thresh=2, rearr_sr_thresh=2, trl_sr_thresh=2,
        batch_regions=True,
    )
    return base, write_s


class _TimedIndexIO:
    """While open, ``GenomeIndex.save`` and ``load`` record their seconds
    and the artifact's size (the save and load inside Runner.setup)."""

    def __enter__(self):
        self.times = {"save_s": None, "load_s": None, "artifact_mb": None}
        self.save, self.load = GenomeIndex.save, GenomeIndex.load
        times, orig_save, orig_load = self.times, self.save, self.load

        def timed_save(gi, path):
            t0 = time.time()
            out = orig_save(gi, path)
            times["save_s"] = time.time() - t0
            times["artifact_mb"] = Path(path).stat().st_size / 1e6
            return out

        def timed_load(cls, path):
            t0 = time.time()
            out = orig_load.__func__(cls, path)
            times["load_s"] = time.time() - t0
            return out

        GenomeIndex.save = timed_save
        GenomeIndex.load = classmethod(timed_load)
        return self.times

    def __exit__(self, *exc):
        GenomeIndex.save, GenomeIndex.load = self.save, self.load


def _round(x):
    return round(x, 1) if x is not None else None


def run(total: int, device: str, reduced=None) -> dict:
    """The whole check at ``total`` bp on ``device``: the JSON record."""
    work = Path(tempfile.mkdtemp(prefix="breakmer_torch_genome_e2e_"))
    try:
        base, write_s = build_fixture(work, total)
        # the fixture's strings are gone with build_fixture's frame, so
        # the runner-phase RSS numbers are the runner's own footprint
        gc.collect()
        rss_fixture_mb = _vm_rss_mb()
        with _TimedIndexIO() as io_times:
            t1 = time.time()
            r1 = Runner(Config(analysis_dir=str(work / "a1"), device=device, **base))
            r1.setup()
            setup_cold_s = time.time() - t1
            t2 = time.time()
            events = r1.run()
            run_s = time.time() - t2
            idx_nbytes = r1.genome.nbytes if r1.genome is not None else 0
            rss_cold_mb = _vm_rss_mb()
            del r1
            gc.collect()

            # warm pass: the cached index artifact must reload and reproduce
            t3 = time.time()
            r2 = Runner(Config(analysis_dir=str(work / "a2"), device=device, **base))
            r2.setup()
            setup_warm_s = time.time() - t3
            events2 = r2.run()
            rss_warm_mb = _vm_rss_mb()

        by_gene = {e.genes: e for e in events}
        ok_ins = (by_gene.get("G_INS") is not None and by_gene["G_INS"].sv_type == "indel"
                  and by_gene["G_INS"].size == len(INS))
        ok_del = by_gene.get("G_DEL") is not None and by_gene["G_DEL"].sv_subtype in ("D", "del")
        ok_trl = by_gene.get("G_TRL") is not None and by_gene["G_TRL"].sv_type == "trl"
        same = len(events) == len(events2) and all(
            a.genes == b.genes and a.sv_type == b.sv_type and a.breakpoints == b.breakpoints
            for a, b in zip(events, events2)
        )
        peak_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        out = {
            "metric": "genome_e2e",
            "total_bp": total,
            "calls": len(events),
            "ins_called": bool(ok_ins),
            "del_called": bool(ok_del),
            "trl_called": bool(ok_trl),
            "warm_equals_cold": bool(same),
            "fasta_write_s": round(write_s, 1),
            "setup_cold_s": round(setup_cold_s, 1),
            "setup_warm_s": round(setup_warm_s, 1),
            "run_s": round(run_s, 1),
            "index_resident_mb": round(idx_nbytes / 1e6, 1),
            "index_save_s": _round(io_times["save_s"]),
            "index_load_s": _round(io_times["load_s"]),
            "index_artifact_mb": _round(io_times["artifact_mb"]),
            "rss_fixture_mb": round(rss_fixture_mb, 1),
            "rss_after_cold_run_mb": round(rss_cold_mb, 1),
            "rss_after_warm_run_mb": round(rss_warm_mb, 1),
            "peak_rss_mb": round(peak_rss_mb, 1),
        }
        if reduced is not None:
            out["reduced"] = reduced
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> dict:
    """The command line; returns the record it printed (exits 1 when a
    planted call is missing or the warm run differs from the cold one)."""
    from breakmer_tpu_torch.device import resolve

    ap = argparse.ArgumentParser(prog="python -m breakmer_tpu_torch.tools.bench_genome_e2e")
    ap.add_argument("total_bp", nargs="?", type=float, default=100_000_000)
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)  # raises without a card unless cpu
    total = int(args.total_bp)
    if total < FLOOR_BP:
        sys.exit("total_bp must be >= 8.5e7: targets sit at fixed "
                 "chr1:10M..40M offsets (chr1 is total/2)")
    mem = meminfo_mb()
    print(f"host RAM: MemTotal {mem['MemTotal']:.0f} MB, MemAvailable "
          f"{mem['MemAvailable']:.0f} MB", flush=True)
    reduced = None
    fits = int(mem["MemAvailable"] * 2**20 / BYTES_PER_BP) // 1_000_000 * 1_000_000
    if total > fits:
        if fits < FLOOR_BP:
            sys.exit(f"MemAvailable {mem['MemAvailable']:.0f} MB holds no run of "
                     f"{FLOOR_BP} bp at {BYTES_PER_BP} bytes a base")
        reduced = {"total_bp": total, "to": fits,
                   "why": f"MemAvailable {mem['MemAvailable']:.0f} MB holds about "
                          f"{BYTES_PER_BP} bytes a base of peak RSS for {fits} bp"}
        print(f"reduced: total_bp {total} -> {fits} (host RAM)", flush=True)
        total = fits
    if dev.type == "cuda":
        from breakmer_tpu_torch.timing import card_line

        print(card_line(), flush=True)
    out = run(total, str(dev), reduced)
    print(json.dumps(out))
    if not (out["ins_called"] and out["del_called"] and out["trl_called"]
            and out["warm_equals_cold"]):
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
