"""Run-wide stage / throughput meter (SURVEY.md §5 tracing-profiling row).

The reference's only observability is elapsed-time log prose
(``sv_processor.py runner.run`` ``time.time()`` deltas, reconstructed —
SURVEY.md §5). Here a process-global meter accumulates per-stage wall
seconds and Smith-Waterman cell-updates across a run; the runner writes
the snapshot — including run-level wall-clock GCUPS, the required metric
from BASELINE.json ("SW GCUPS/chip") — into ``<analysis_dir>/metrics.json``.

Under multihost each process meters itself; process 0's metrics.json
reports process 0's stages (region work is host-partitioned, so every
process runs the same stage mix over its own shard).

The port's runner also spans the rest of a sample's wall (set-up, the
index load, region references, the normal's reads, the ledger and the
output files), and ``cli run --profile`` puts every stage on the
profiler's timeline as a ``breakmer.<name>`` range (``profile``).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager


# METER.germline's counters, in the order metrics.json lists them
GERMLINE_COUNTS = ("events", "germline_by_kmers", "somatic_by_kmers", "kmers_inconclusive",
                   "candidates", "alignments", "germline_by_alignment", "kept")
# METER.normal_reads's counters: regions whose normal reads came as columns
# through the normal's index or record by record, the records the columnar
# fetch decoded (before its overlap rule) and the reads the batches kept
NORMAL_READS_COUNTS = ("regions_columnar", "regions_records", "records_decoded", "reads_kept")
# METER.sample_reads's counters: the records of the sample's whole-file
# ingest, the rows whose variable-width fields were decoded (summed over
# the gathers that asked for them) and the inflated stream held, in MB
SAMPLE_READS_COUNTS = ("records", "rows_gathered", "inflated_mb")


class Meter:
    def __init__(self) -> None:
        # set by cli.run_profiled alone: a range that encloses launches is
        # mirrored on the device timeline, which an idle count reads as busy
        self.profile = False
        self._lock = threading.Lock()  # counters may be added from the runner's worker threads
        self.reset()

    def reset(self) -> None:
        self.owner = None  # the Runner whose set-up these counters hold
        self.stage_s: dict = defaultdict(float)
        self.sw_cells = 0
        self.sw_s = 0.0
        self.sw_launches = 0
        # how the sample's set-up got its genome index: {"source": "mapped"
        # | "converted" | "built", "bytes": the index's arrays}
        self.index = None
        # the germline recheck against a matched normal (pipeline.py): events
        # rechecked, the k-mer test's verdicts, candidate normal reads (pairs
        # of an event and a read's strand), alignments traced back, germline
        # by alignment and events kept
        self.germline: dict = defaultdict(int)
        self.normal_reads: dict = defaultdict(int)
        self.sample_reads: dict = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        span = None  # the profiler's range lies inside the timed interval
        if self.profile:
            from torch.profiler import record_function

            span = record_function(f"breakmer.{name}").__enter__()
        try:
            yield
        finally:
            if span is not None:
                span.__exit__(None, None, None)
            self.stage_s[name] += time.perf_counter() - t0

    def add_germline(self, counts: dict) -> None:
        self._add(self.germline, counts)

    def add_normal_reads(self, counts: dict) -> None:
        self._add(self.normal_reads, counts)

    def add_sample_reads(self, counts: dict) -> None:
        self._add(self.sample_reads, counts)

    def _add(self, table: dict, counts: dict) -> None:
        with self._lock:
            for key, n in counts.items():
                table[key] += n

    def add_sw(self, cells: int, secs: float) -> None:
        self.sw_cells += int(cells)
        self.sw_s += secs
        self.sw_launches += 1

    def snapshot(self) -> dict:
        out = {
            "stage_s": {k: round(v, 4) for k, v in sorted(self.stage_s.items())}
        }
        if self.sw_launches:
            out["sw"] = {
                "launches": self.sw_launches,
                "cells": self.sw_cells,
                "wall_s": round(self.sw_s, 4),
                # end-to-end GCUPS including dispatch/fetch overhead —
                # honest pipeline number; bench.py's slope-fit kernel
                # GCUPS excludes the relay floor by design
                # 6 decimals: a cold-compile CPU run can be ~1e-5 GCUPS
                "gcups_wall": (
                    round(self.sw_cells / self.sw_s / 1e9, 6) if self.sw_s > 0 else 0.0
                ),
            }
        if self.index is not None:
            out["index"] = dict(self.index)
        if self.germline:
            out["germline"] = {k: self.germline[k] for k in GERMLINE_COUNTS}
        if self.normal_reads:
            out["normal_reads"] = {k: self.normal_reads[k] for k in NORMAL_READS_COUNTS}
        if self.sample_reads:
            out["sample_reads"] = {k: self.sample_reads[k] for k in SAMPLE_READS_COUNTS}
        return out


# Process-global, intentionally unsynchronized. INVARIANT: one active
# Runner per process — Runner.run() resets it, and the device stages that
# feed it (sw_score_batch) run on the runner's thread. Library callers
# wanting isolated counters should instantiate their own Meter; host
# worker THREADS inside one runner are fine (adds are GIL-atomic enough
# for coarse wall metrics). With nprocs>1 worker threads, stage() sums
# per-thread wall across overlapping regions, so a stage's total can
# exceed the run's wall clock — read stage_s as aggregate stage cost.
# Runner.setup() resets it too and names itself ``owner``; run() then
# keeps the set-up's spans, whether it or its caller called setup().
METER = Meter()
