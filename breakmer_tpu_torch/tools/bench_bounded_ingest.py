"""Bounded-memory ingest at production BAM scale, through the port.

Port of ``tools/bench_bounded_ingest.py``, with the same fixture and JSON
line. It builds a deep-coverage synthetic BAM whose uncompressed body is
>= ``uncompressed_gb`` (default 1.2 GB, with its .bai), then runs the
same panel twice, each in a fresh child process running the port's
Runner on ``--device``:

  indexed : preload_max_mb below the file size, so the runner picks
            BamIndexedReader's per-region seeks; peak RSS must stay far
            below the inflated file size
  preload : the guard off: whole-file inflate + native columnar decode

and prints both peak RSS numbers (VmHWM, which resets on exec; where
/proc has none, the largest VmRSS sampled every 10 ms) with the call
identity:

    python -m breakmer_tpu_torch.tools.bench_bounded_ingest [uncompressed_gb] [--device cuda]
    python -m breakmer_tpu_torch.tools.bench_bounded_ingest --child <mode> <workdir> [--device D]

``--device`` (default ``cuda``; raises without a card unless ``cpu``) is
the children's Runner device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from breakmer_tpu_torch.tools import REPO

READ_LEN = 250
CHROM_LEN = 2_000_000


def _status_mb(field: str):
    """A field of /proc/self/status in MB, or None where the kernel does
    not report it."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith(field + ":"):
            return int(line.split()[1]) / 1024
    return None


class _RssSampler(threading.Thread):
    """The largest VmRSS seen every ``period`` seconds until ``stop``."""

    def __init__(self, period: float = 0.01):
        super().__init__(daemon=True)
        self.period, self.peak_mb, self.done = period, 0.0, threading.Event()

    def run(self):
        while not self.done.wait(self.period):
            self.peak_mb = max(self.peak_mb, _status_mb("VmRSS") or 0.0)

    def stop(self) -> float:
        self.done.set()
        self.join()
        return max(self.peak_mb, _status_mb("VmRSS") or 0.0)


def _peak_rss_mb(sampler: "_RssSampler") -> float:
    """VmHWM, not resource.ru_maxrss: Linux keeps ru_maxrss across execve,
    so a child forked from a fat parent would report the parent's peak.
    VmHWM resets on exec. Where /proc reports no VmHWM (not every kernel
    does), the largest VmRSS the child's sampler saw."""
    hwm = _status_mb("VmHWM")
    peak = sampler.stop()
    return hwm if hwm is not None else peak


def _child(mode: str, work: Path, device: str) -> None:
    sampler = _RssSampler()
    sampler.start()
    from breakmer_tpu_torch.config import Config
    from breakmer_tpu_torch.runner import Runner

    bam = work / "deep.bam"
    size_mb = bam.stat().st_size / 2**20
    cfg = Config(
        analysis_name="ingest",
        analysis_dir=str(work / f"analysis_{mode}"),
        targets_bed_file=str(work / "targets.bed"),
        reference_fasta=str(work / "genome.fa"),
        reference_data_dir=str(work / f"refdata_{mode}"),
        sample_bam_file=str(bam),
        kmer_size=15,
        indel_sr_thresh=2,
        rearr_sr_thresh=2,
        # indexed: threshold under the on-disk size -> auto-switch;
        # preload: guard off -> whole-file inflate
        preload_max_mb=(size_mb / 2) if mode == "indexed" else None,
        device=device,
    )
    r = Runner(cfg)
    r.setup()
    t0 = time.time()
    events = r.run()
    run_s = time.time() - t0
    if mode == "indexed":
        if r._preload_effective() is not False:
            raise RuntimeError("the preload guard did not trip")
        if r._sample_records is not None or r._native_cols is not None:
            raise RuntimeError("the indexed run preloaded the BAM")
    elif r._preload_effective() is not True:
        raise RuntimeError("the preload run did not preload")
    print(json.dumps({
        "mode": mode,
        "calls": [[e.genes, e.sv_type, e.sv_subtype, e.breakpoints] for e in events],
        "run_s": round(run_s, 1),
        "peak_rss_mb": round(_peak_rss_mb(sampler), 1),
    }))


def _build_fixture(work: Path, target_gb: float) -> dict:
    """Deep-coverage BAM: SV reads from the noisy fixture builder over two
    target genes, plus bulk perfect-match background reads tiled over the
    chromosome until the uncompressed BAM body crosses target_gb."""
    from breakmer_tpu_torch.io.bam import write_bam
    from breakmer_tpu_torch.io.fasta import write_fasta
    from breakmer_tpu_torch.io.sam import SamRecord, parse_sam_line
    from breakmer_tpu_torch.testing.fixtures import (ErrorModel, Haplotype, NovelBlock,
                                                     RefBlock, SamBuilder, rand_seq)

    genome = {"chr1": rand_seq(5, CHROM_LEN)}
    write_fasta(work / "genome.fa", genome)
    targets = [("chr1", 1_000_000, 1_000_600, "GENE1"),
               ("chr1", 1_500_000, 1_500_600, "GENE2")]
    with open(work / "targets.bed", "w") as fh:
        for c, s, e, g in targets:
            fh.write(f"{c}\t{s}\t{e}\t{g}\n")

    INS = "TTGACCATGGATCCGGTACAT"
    sam = SamBuilder(genome, error_model=ErrorModel(), error_seed=3)
    sam.add_haplotype_reads(Haplotype(genome, [
        RefBlock("chr1", 1_000_000, 1_000_300), NovelBlock(INS),
        RefBlock("chr1", 1_000_300, 1_000_600),
    ]), 180, 440, prefix="g1")
    sam.add_haplotype_reads(Haplotype(genome, [
        RefBlock("chr1", 1_500_000, 1_500_300),
        RefBlock("chr1", 1_500_360, 1_500_600),
    ]), 180, 440, prefix="g2")
    for c, s, e, g in targets:
        sam.add_background_pairs(c, s - 200, e + 200, prefix=f"bg{g}")
    records = [parse_sam_line(ln) for ln in sam.lines]

    # bulk coverage: perfect-match reads, empty qual (the writer emits the
    # 0xff no-qual sentinel), ~rec_bytes uncompressed each
    rec_bytes = 32 + 14 + 4 + (READ_LEN + 1) // 2 + READ_LEN
    n_bulk = int(target_gb * 1e9 / rec_bytes)
    chrom = genome["chr1"]
    cigar = [(READ_LEN, "M")]
    stride = max(1, (CHROM_LEN - READ_LEN) // max(1, n_bulk))
    bulk = []
    pos, i = 0, 0
    while i < n_bulk:
        if pos >= CHROM_LEN - READ_LEN:
            pos = (pos % 7) + 1  # next lap, phase-shifted
        bulk.append(SamRecord(
            qname=f"b{i}", flag=0, rname="chr1", pos=pos, mapq=60,
            cigar=cigar, rnext="*", pnext=-1, tlen=0,
            seq=chrom[pos:pos + READ_LEN], qual=[],
        ))
        pos += stride
        i += 1
    records.extend(bulk)
    del bulk
    records.sort(key=lambda r: r.pos)
    uncompressed_mb = (len(records) * rec_bytes) / 1e6  # close estimate
    t0 = time.time()
    write_bam(work / "deep.bam", [("chr1", CHROM_LEN)], records, index=True)
    write_s = time.time() - t0
    return {
        "records": len(records),
        "read_len": READ_LEN,
        "coverage_x": round(len(records) * READ_LEN / CHROM_LEN),
        "uncompressed_mb_est": round(uncompressed_mb),
        "bam_mb": round((work / "deep.bam").stat().st_size / 2**20, 1),
        "write_s": round(write_s, 1),
    }


def run_child(mode: str, work: Path, device: str) -> dict:
    """One child process of ``mode`` from the checkout's root: its JSON."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    p = subprocess.run(
        [sys.executable, "-m", "breakmer_tpu_torch.tools.bench_bounded_ingest", "--child",
         mode, str(work), "--device", device],
        capture_output=True, text=True, timeout=3600, cwd=str(REPO), env=env,
    )
    if p.returncode != 0:
        sys.exit(f"{mode} child failed:\n{p.stderr[-3000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    from breakmer_tpu_torch.device import resolve

    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(prog="python -m breakmer_tpu_torch.tools.bench_bounded_ingest")
    if argv and argv[0] == "--child":
        ap.add_argument("--child", nargs=2, metavar=("MODE", "WORKDIR"))
        ap.add_argument("--device", default="cuda")
        args = ap.parse_args(argv)
        _child(args.child[0], Path(args.child[1]), str(resolve(args.device)))
        return
    ap.add_argument("uncompressed_gb", nargs="?", type=float, default=1.2)
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    device = str(resolve(args.device))  # raises without a card unless cpu
    work = Path(tempfile.mkdtemp(prefix="breakmer_torch_ingest_"))
    try:
        fx = _build_fixture(work, args.uncompressed_gb)
        out = {mode: run_child(mode, work, device) for mode in ("indexed", "preload")}
        same = out["indexed"]["calls"] == out["preload"]["calls"]
        genes = [c[0] for c in out["indexed"]["calls"]]
        print(json.dumps({
            "metric": "bounded_ingest",
            **fx,
            "calls_identical": bool(same),
            "ins_and_del_called": genes == ["GENE1", "GENE2"],
            "indexed_peak_rss_mb": out["indexed"]["peak_rss_mb"],
            "indexed_run_s": out["indexed"]["run_s"],
            "preload_peak_rss_mb": out["preload"]["peak_rss_mb"],
            "preload_run_s": out["preload"]["run_s"],
            "note": "indexed mode = preload_max_mb guard tripped "
                    "(auto-selected BamIndexedReader); RSS bound must hold "
                    "as file size grows, preload RSS scales with it",
        }))
        if not same:
            sys.exit(1)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
