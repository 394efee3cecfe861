"""Where a sample's reads come from: decided once a run, behind one seam.

``open_sample_reads(cfg)`` picks the tumour's source by these rules, in
this order, and returns an object of one class a source, which answers the
runner's five questions of it: ``extract``, ``all_reads``, ``depth_at``,
``discordant_pairs`` and ``prewarm``.

1. ``preload_alignments``, unless the file is a ``.bam`` larger than
   ``preload_max_mb`` on disk with a sidecar ``.bai``/``.csi``: a whole-file
   inflate of a production-scale BAM must never be the default, and the
   index serves each region at a cost independent of the file's size.
   Without an index the file is preloaded all the same, with a warning.
2. Preloaded, a ``.bam`` with the BAM ingest library
   (``io/bam_ingest.py``) or a ``.sam`` with the native library:
   ``NativeReads``, the whole file ingested once into fixed-width columns
   (``ColumnReads``), the variable-width fields of a row decoded when a
   region asks for it (a ``.bam``) or with the columns (a ``.sam``). Where
   the ingest refuses the file, its records serve instead
   (``PreloadedReads``).
3. Otherwise the file's records: parsed once and binned by interval
   (``PreloadedReads``), a seek a region through the index
   (``IndexedReads``, a ``.bam`` with one), or a parse of the file a region
   (``ParsedReads``).

``open_normal_reads(cfg)`` does the same for the matched normal, whose
reads come a region at a time: as columns through its index
(``io/bam_columns.BamColumnReader``), or record by record.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from breakmer_tpu_torch import native
from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.encode import ReadBatch
from breakmer_tpu_torch.extract import (
    ExtractResult,
    extract_all_reads,
    extract_all_reads_columnar,
    extract_sv_reads,
    extract_sv_reads_columnar,
    global_discordant_pairs,
    global_discordant_pairs_columnar,
)
from breakmer_tpu_torch.io import bam_ingest
from breakmer_tpu_torch.io.bam import BamIndexedReader, find_index, read_alignments
from breakmer_tpu_torch.io.bam_columns import BamColumnReader, column_qnames
from breakmer_tpu_torch.io.bam_ingest import DecodedFields, RowFields
from breakmer_tpu_torch.io.bed import TargetRegion
from breakmer_tpu_torch.utils.logging import get_logger
from breakmer_tpu_torch.utils.meter import METER

log = get_logger("reads")


def _preloads(cfg: Config) -> bool:
    """Rule 1: whether this run preloads the sample's alignment file."""
    path = str(cfg.sample_bam_file)
    if not cfg.preload_alignments or cfg.preload_max_mb is None or not path.endswith(".bam"):
        return bool(cfg.preload_alignments)
    size_mb = Path(path).stat().st_size / 2**20
    if size_mb <= cfg.preload_max_mb:
        return True
    if find_index(path) is not None:
        log.info("sample BAM is %.0f MiB on disk (> preload_max_mb=%g) with a sidecar index: "
                 "using indexed per-region fetch (bounded memory)", size_mb, cfg.preload_max_mb)
        return False
    log.warning("sample BAM is %.0f MiB on disk (> preload_max_mb=%g) but has no .bai/.csi "
                "index; preloading whole file — index it to bound memory",
                size_mb, cfg.preload_max_mb)
    return True


def open_sample_reads(cfg: Config):
    """The sample's reads, from the source the module's rules pick."""
    path = str(cfg.sample_bam_file)
    if not _preloads(cfg):
        if path.endswith(".bam") and find_index(path) is not None:
            return IndexedReads(cfg)
        return ParsedReads(cfg)
    if path.endswith(".bam") and bam_ingest.available() or (
            path.endswith(".sam") and native.available()):
        return NativeReads(cfg)
    return PreloadedReads(cfg)


class SampleReads:
    """What every source shares: the run-level discordant-pair map, built
    once, and ``prewarm``. Worker threads may share one after ``prewarm``."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self._disc = None  # discordant_pairs()

    def discordant_pairs(self):
        """The run-level discordant-pair map (cfg.global_disc_support), one
        qname-deduped entry a pair; built on the first call."""
        if self._disc is None:
            t0 = time.time()
            self._disc = self._discordant_pairs()
            log.info("global discordant map: %d pairs in %.1fs", len(self._disc),
                     time.time() - t0)
        return self._disc

    def prewarm(self) -> None:
        """Build the state shared between regions on the calling thread, so
        that worker threads only read it."""


class RecordReads(SampleReads):
    """The sample's reads as parsed records, which a subclass serves a
    region at a time through ``records(chrom, start, end)``, in file order."""

    def extract(self, target: TargetRegion) -> ExtractResult:
        """The region's SV reads; the records are gathered first, then
        classified in the ``extract_clean`` span."""
        region = target.span(self.cfg.region_buffer)
        records = self.records(*region)
        with METER.stage("extract_clean"):
            return extract_sv_reads(records, region, self.cfg)

    def all_reads(self, target: TargetRegion) -> ReadBatch:
        """EVERY primary read of the region: the contig-extension pool
        (assemble/extend.py), built only when a region asks for it."""
        region = target.span(self.cfg.region_buffer)
        return extract_all_reads(self.records(*region), region)

    def depth_at(self, chrom: str, pos: int) -> int:
        """Primary mapped reads over ``pos`` anywhere in the genome: serves
        breakpoints outside the region window (a translocation partner's),
        which the region's own coverage cannot see."""
        return sum(1 for r in self.records(chrom, pos, pos + 1)
                   if not (r.is_unmapped or r.is_secondary or r.is_supplementary))

    def _discordant_pairs(self):
        return global_discordant_pairs(self.every_record(), self.cfg)

    def every_record(self):
        """The file's records, in file order."""
        return read_alignments(self.cfg.sample_bam_file)


class PreloadedReads(RecordReads):
    """The file parsed whole on the first call, its records binned by
    interval per chromosome: a linear scan a region with Python overlap
    tests dominated warm panel time at O(targets x records)."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self._records: Optional[list] = None  # in file order
        self._bins = None  # per-chrom (index, pos, end) arrays sorted by pos

    def records(self, chrom: str, start: int, end: int) -> list:
        entry = self._preloaded().get(chrom)
        if entry is None:
            return []
        idx, pos, eend = entry
        hi = int(np.searchsorted(pos, end, "left"))
        cand = idx[:hi][eend[:hi] > start]
        cand.sort()  # restore file order (the scan's iteration order)
        return [self._records[i] for i in cand]

    def _preloaded(self) -> dict:
        """The per-chrom interval bins. The end of an unmapped record is
        pos + 1, which reproduces ``record_overlaps``
        (start <= pos < end  <=>  pos + 1 > start and pos < end)."""
        if self._bins is None:
            t0 = time.time()
            recs = self._records = list(read_alignments(self.cfg.sample_bam_file))
            log.info("loaded %d alignment records in %.1fs", len(recs), time.time() - t0)
            by_chrom: dict = {}
            for i, r in enumerate(recs):
                by_chrom.setdefault(r.rname, []).append(i)
            bins = {}
            for name, idx_list in by_chrom.items():
                idx = np.asarray(idx_list, dtype=np.int64)
                pos = np.asarray([recs[i].pos for i in idx_list], dtype=np.int64)
                eend = np.asarray([recs[i].pos + 1 if recs[i].is_unmapped
                                   else recs[i].reference_end() for i in idx_list],
                                  dtype=np.int64)
                order = np.argsort(pos, kind="stable")
                bins[name] = (idx[order], pos[order], eend[order])
            self._bins = bins
        return self._bins

    def every_record(self) -> list:
        self._preloaded()
        return self._records

    def prewarm(self) -> None:
        self._preloaded()


class IndexedReads(RecordReads):
    """A seek a region through the ``.bam``'s index, on one file handle
    that worker threads take in turn; nothing of the file is held."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self._reader = BamIndexedReader(cfg.sample_bam_file)
        self._lock = threading.Lock()

    def records(self, chrom: str, start: int, end: int) -> list:
        with self._lock:
            return list(self._reader.fetch(chrom, start, end))


class ParsedReads(RecordReads):
    """A parse of the file a region (``preload_alignments`` off, no index)."""

    def records(self, chrom: str, start: int, end: int):
        return read_alignments(self.cfg.sample_bam_file, region=(chrom, start, end))

    def depth_at(self, chrom: str, pos: int) -> int:
        """0, as in the JAX package: this source holds no view of the genome
        outside the region, and a parse of the file a breakpoint would be
        the price of one."""
        return 0


class NativeReads:
    """The whole file ingested on the first question asked of it, in its
    own ``bam_decode`` span: a ``.bam`` by ``bam_ingest.ingest_bam`` (its
    fixed-width columns over the inflated stream), a ``.sam`` by the native
    library's decode of every field. From then on every question goes to
    ``resolved``: ``ColumnReads`` over the columns, or ``PreloadedReads``
    where the ingest refused the file. ``METER.sample_reads`` counts the
    records and the inflated stream's MB."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.resolved = None

    def _reads(self):
        if self.resolved is None:
            path = str(self.cfg.sample_bam_file)
            is_bam = path.endswith(".bam")
            t0 = time.time()
            with METER.stage("bam_decode"):
                if is_bam:
                    out = bam_ingest.ingest_bam(path)
                else:
                    # the per-line Python parse was ~25% of warm panel time
                    out = native.sam_decode_columns(Path(path).read_bytes())
                    out = None if out is None else (*out, DecodedFields(out[0]))
            if out is None:
                self.resolved = PreloadedReads(self.cfg)
            else:
                cols, _, fields = out
                METER.add_sample_reads({"records": cols["n"],
                                        "inflated_mb": round(fields.inflated_bytes / 1e6, 3)})
                log.info("native %s ingest: %d records in %.1fs", "BAM" if is_bam else "SAM",
                         cols["n"], time.time() - t0)
                self.resolved = ColumnReads(self.cfg, *out)
        return self.resolved

    def extract(self, target: TargetRegion) -> ExtractResult:
        return self._reads().extract(target)

    def all_reads(self, target: TargetRegion) -> ReadBatch:
        return self._reads().all_reads(target)

    def depth_at(self, chrom: str, pos: int) -> int:
        return self._reads().depth_at(chrom, pos)

    def discordant_pairs(self):
        return self._reads().discordant_pairs()

    def prewarm(self) -> None:
        self._reads().prewarm()


class ColumnReads(SampleReads):
    """A sample's fixed-width columns (``bam_ingest.ingest_bam``, or
    ``native.sam_decode_columns``), each region classified by vectorised
    numpy, and the variable-width fields of the rows it keeps from
    ``fields``."""

    def __init__(self, cfg: Config, cols: dict, ref_names: list, fields: RowFields):
        super().__init__(cfg)
        self.cols, self.ref_names, self.fields = cols, ref_names, fields
        self._cov_bins = None  # _coverage_bins()

    def _coverage_bins(self) -> dict:
        """Per-refid sorted (pos, end) arrays over the primary mapped rows,
        with the largest reference span, so that ``depth_at`` looks at
        candidates only and never scans the whole table."""
        if self._cov_bins is None:
            cols = self.cols
            bins = {}
            keep = (cols["flag"] & (0x4 | 0x100 | 0x800)) == 0
            refid = cols["refid"][keep]
            rpos = cols["pos"][keep].astype(np.int64, copy=False)
            eend = rpos + cols["ref_span"][keep]
            for rid in np.unique(refid):
                sel = refid == rid
                p, e = rpos[sel], eend[sel]
                order = np.argsort(p, kind="stable")
                p, e = p[order], e[order]
                # the largest span bounds how far left an overlapping record
                # can start: the query window becomes (q - span_max, q]
                span_max = int((e - p).max()) if len(p) else 0
                bins[int(rid)] = (p, e, span_max)
            self._cov_bins = bins
        return self._cov_bins

    def extract(self, target: TargetRegion) -> ExtractResult:
        with METER.stage("extract_clean"):
            return extract_sv_reads_columnar(self.cols, self.fields, self.ref_names,
                                             target.span(self.cfg.region_buffer), self.cfg)

    def all_reads(self, target: TargetRegion) -> ReadBatch:
        return extract_all_reads_columnar(self.cols, self.fields, self.ref_names,
                                          target.span(self.cfg.region_buffer))

    def depth_at(self, chrom: str, pos: int) -> int:
        if chrom not in self.ref_names or not self.cols.get("n"):
            return 0
        entry = self._coverage_bins().get(self.ref_names.index(chrom))
        if entry is None:
            return 0
        rpos, eend, span_max = entry
        hi = int(np.searchsorted(rpos, pos, "right"))
        lo = int(np.searchsorted(rpos, pos - span_max, "right"))
        return int((eend[lo:hi] > pos).sum())

    def _discordant_pairs(self):
        return global_discordant_pairs_columnar(self.cols, self.fields, self.ref_names, self.cfg)

    def prewarm(self) -> None:
        self._coverage_bins()


def open_normal_reads(cfg: Config) -> "NormalReads":
    """The matched normal's reads: as columns where the normal is a ``.bam``
    with a sidecar index and the native library loads, otherwise as records."""
    path = str(cfg.normal_bam_file)
    columnar = path.endswith(".bam") and find_index(path) is not None and native.available()
    return NormalReads(cfg, BamColumnReader(path) if columnar else None)


class NormalReads:
    """The matched normal's reads a region, in file order, quals dropped:
    as columns from ``reader`` (``BamColumnReader.fetch_columns``; its index
    and header parsed once a sample), or record by record where ``reader``
    is None. Both give the same batch."""

    def __init__(self, cfg: Config, reader: Optional[BamColumnReader]):
        self.cfg, self.reader = cfg, reader

    def batch(self, target: TargetRegion) -> Optional[ReadBatch]:
        chrom, start, end = target.span(self.cfg.region_buffer)
        cols = self.reader.fetch_columns(chrom, start, end) if self.reader else None
        if cols is not None:
            rows = np.flatnonzero(cols["lseq"] > 0) if cols["n"] else []
            METER.add_normal_reads({"regions_columnar": 1, "records_decoded": cols["decoded"],
                                    "reads_kept": len(rows)})
            if not len(rows):
                return None
            lengths = cols["lseq"][rows]
            return ReadBatch(
                codes=cols["seq_codes"][rows, : int(lengths.max())],  # a copy
                lengths=lengths, names=column_qnames(cols["names"][rows]),
            )
        seqs, names = [], []
        for rec in read_alignments(self.cfg.normal_bam_file, region=(chrom, start, end)):
            if rec.seq and rec.seq != "*":
                seqs.append(rec.seq)
                names.append(rec.qname)
        METER.add_normal_reads({"regions_records": 1, "reads_kept": len(seqs)})
        return ReadBatch.from_seqs(seqs, names=names) if seqs else None

    def close(self) -> None:
        if self.reader is not None:
            self.reader.close()
