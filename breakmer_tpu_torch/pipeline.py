"""Per-target-region pipeline.

Reference: sv_processor.py ``class target`` (SURVEY.md §2 #4, §3.2-3.3):
per-region state + the two-phase driver — ``find_sv_reads`` (extract ->
clean -> k-mer subtract) and ``resolve_sv`` (assemble -> realign -> call).
The reference round-trips every stage through files and subprocesses; here
each stage hands packed arrays to the next, with the device doing k-mer
work and batched SW scoring.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, Iterable, List, Optional

import numpy as np

from breakmer_tpu_torch._build import DEVICE_FAULTS
from breakmer_tpu_torch.align.index import GenomeIndex
from breakmer_tpu_torch.align.realign import RegionRef
from breakmer_tpu_torch.assemble.greedy import Contig, assemble
from breakmer_tpu_torch.call.events import SVEvent, classify_contig
from breakmer_tpu_torch.call.filters import apply_filters
from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.encode import ReadBatch
from breakmer_tpu_torch.extract import ExtractResult, clean_reads, extract_sv_reads
from breakmer_tpu_torch.io.bed import TargetRegion
from breakmer_tpu_torch.io.sam import SamRecord
from breakmer_tpu_torch.ops.kmer import sample_only_kmers
from breakmer_tpu_torch.ops.sw import SWParams
from breakmer_tpu_torch.utils.logging import get_logger
from breakmer_tpu_torch.utils.meter import METER
from breakmer_tpu_torch.utils.rmask import RepeatMask

log = get_logger("pipeline")


@dataclasses.dataclass
class RegionResult:
    """Everything the runner aggregates per target (reference:
    target.complete_analysis output)."""

    target: TargetRegion
    events: List[SVEvent]
    all_events: List[SVEvent]       # including filtered (observability)
    contigs: List[Contig]
    n_records: int = 0
    n_sv_reads: int = 0
    n_clean_reads: int = 0
    n_sample_kmers: int = 0
    error: Optional[str] = None


def _dedup_identical(events):
    """Suppress events identical in CALL content (type, subtype, size,
    breakpoints, strands) emitted by sister contigs — e.g. two haplotype
    contigs of one het junction that exact-overlap OLC cannot merge
    (they differ by het SNPs). Per-contig duplicate rows are pure noise
    downstream; the survivor is the first-seen event (contig order is
    deterministic) with the maximum support counts over the group.
    Config knob ``dedup_identical_events`` (default on) restores
    per-contig emission when off (r4)."""
    seen = {}
    out = []
    for ev in events:
        # strand is REPRESENTATION for single-junction indels (a sister
        # contig assembled reverse-complement makes the same call with
        # strands '-'); it is call content only for rearrangements/trl
        # where orientation distinguishes events
        #
        # insertions additionally key on the inserted CONTENT
        # (orientation-normalized junction_q slice): two distinct
        # same-size inserts at one breakpoint (tri-allelic het) are
        # different calls, not duplicates (ADVICE r4 #4)
        ins_key = None
        if (ev.sv_subtype == "I" and len(ev.junction_q) == 2
                and ev.contig_seq):
            raw = ev.contig_seq[ev.junction_q[0]:ev.junction_q[1]]
            rc = raw.translate(str.maketrans("ACGT", "TGCA"))[::-1]
            ins_key = min(raw, rc)
        key = (ev.sv_type, ev.sv_subtype, ev.size, tuple(ev.breakpoints),
               None if ev.sv_type == "indel" else ev.strands, ins_key)
        first = seen.get(key)
        if first is None:
            seen[key] = ev
            out.append(ev)
        else:
            first.split_read_count = max(first.split_read_count,
                                         ev.split_read_count)
            first.disc_read_count = max(first.disc_read_count,
                                        ev.disc_read_count)
            ev.filter_reason = "duplicate_call"
    return out


class TargetPipeline:
    """Drives one target region end-to-end (reference: class target)."""

    def __init__(
        self,
        cfg: Config,
        target: TargetRegion,
        region_ref: RegionRef,
        genome: Optional[GenomeIndex] = None,
        rmask: Optional[RepeatMask] = None,
        normal_batch: Optional[ReadBatch] = None,
        *,
        device,
        coverage_at=None,
        user_filter: Optional[RepeatMask] = None,
        all_reads=None,
        disc_override=None,
    ):
        self.cfg = cfg
        self.device = device  # torch.device of the k-mer and SW stages
        self.target = target
        self.region_ref = region_ref
        self.genome = genome
        self.rmask = rmask
        self.user_filter = user_filter  # RepeatMask-style interval set (filter_list)
        self.normal_batch = normal_batch
        self.extract_result: Optional[ExtractResult] = None
        self.clean_batch: Optional[ReadBatch] = None
        self.kmer_values: Optional[np.ndarray] = None
        self.kmer_counts: Optional[np.ndarray] = None
        # optional genome-wide depth callback (chrom, pos) -> int for
        # breakpoints outside the region (e.g. translocation partners);
        # the region's own coverage array takes precedence
        self.global_coverage_at = coverage_at
        # run-level discordant-pair map (cfg.global_disc_support); replaces
        # the region-local map at classify time
        self.disc_override = disc_override
        # lazy provider of EVERY primary region read (ReadBatch) for the
        # contig-extension pass (assemble/extend.py): called only when
        # contigs were assembled and cfg.contig_extension is on, and dropped
        # right after — the all-reads batch is never held across regions
        # (bounded-ingest memory envelope)
        self.all_reads_provider = all_reads

    # -- phase 1: find_sv_reads (reference: target.find_sv_reads) ----------
    def extract_and_clean(
        self,
        records: Optional[Iterable[SamRecord]] = None,
        extract_result: Optional[ExtractResult] = None,
    ) -> bool:
        """Extraction + cleaning only (the batched runner computes k-mers
        for many regions in one device launch; see parallel/kmer_batch).
        ``extract_result`` injects a prebuilt extraction (the runner's,
        from ``reads.py``)."""
        cfg = self.cfg
        with METER.stage("extract_clean"):
            if extract_result is not None:
                self.extract_result = extract_result
            else:
                chrom, start, end = self.target.span(cfg.region_buffer)
                self.extract_result = extract_sv_reads(
                    records, (chrom, start, end), cfg
                )
            batch = self.extract_result.batch
            if len(batch) == 0:
                return False
            self.clean_batch = clean_reads(
                batch,
                trim_qual=cfg.trim_qual,
                min_len=cfg.min_read_len,
                adapter_3p=cfg.adapter_3p,
                adapter_5p=cfg.adapter_5p,
                adapter_error_rate=cfg.adapter_error_rate,
            )
        # reference parity: the pipeline continues only with enough
        # surviving SV reads (target.clean_reads re-checks the count)
        return len(self.clean_batch) >= cfg.min_sv_reads

    def set_kmers(self, values: np.ndarray, counts: np.ndarray) -> None:
        """Inject precomputed sample-only k-mers (batched device path)."""
        self.kmer_values = values
        self.kmer_counts = counts

    def find_sv_reads(
        self,
        records: Optional[Iterable[SamRecord]] = None,
        extract_result: Optional[ExtractResult] = None,
    ) -> bool:
        cfg = self.cfg
        if not self.extract_and_clean(records, extract_result):
            return False
        normal = self.normal_batch
        with METER.stage("kmer_device"):
            self.kmer_values, self.kmer_counts = sample_only_kmers(
                self.clean_batch.codes,
                self.clean_batch.lengths,
                self.region_ref.codes,
                cfg.kmer_size,
                normal_codes=normal.codes if normal is not None and len(normal) else None,
                normal_lengths=normal.lengths if normal is not None and len(normal) else None,
                min_count=cfg.min_kmer_count,
                device=self.device,
            )
        return len(self.kmer_values) > 0

    # -- phase 2: resolve_sv (reference: target.resolve_sv) ----------------
    def _empty_result(self) -> RegionResult:
        return RegionResult(
            target=self.target,
            events=[],
            all_events=[],
            contigs=[],
            n_records=self.extract_result.n_records if self.extract_result else 0,
            n_sv_reads=self.extract_result.n_sv_reads if self.extract_result else 0,
            n_clean_reads=len(self.clean_batch) if self.clean_batch else 0,
            n_sample_kmers=len(self.kmer_values) if self.kmer_values is not None else 0,
        )

    def sw_params(self) -> SWParams:
        cfg = self.cfg
        return SWParams(
            match=cfg.match_score,
            mismatch=cfg.mismatch_pen,
            gap_open=cfg.gap_open_pen,
            gap_extend=cfg.gap_extend_pen,
        )

    def realign_opts(self) -> dict:
        cfg = self.cfg
        return dict(
            min_seg_len=min(cfg.trl_min_seg_len, cfg.rearr_min_seg_len),
            min_identity=cfg.min_identity,
            full_hit_cov=cfg.full_hit_cov,
            max_segments=cfg.max_segments,
            # genome-aware uniqueness margins cost ~3x warm realign time
            # (genome candidate gathering per contig per round); only the
            # repeat filter's rescue consumes them, so pay only when an
            # rmask is actually in play (the one INJECTED into this
            # pipeline, not just the config path — TargetPipeline
            # supports direct rmask injection) with the rescue enabled —
            # without margins second_score stays -1 and the rescue
            # (correctly) never fires
            genome_margins=(self.rmask is not None
                            or bool(cfg.repeat_mask_file))
            and cfg.repeat_uniq_rescue and not cfg.keep_repeat_regions,
        )

    def assemble_contigs(self) -> List[Contig]:
        cfg = self.cfg
        if self.kmer_values is None or len(self.kmer_values) == 0:
            self.contigs: List[Contig] = []
            return self.contigs
        with METER.stage("assemble"):
            self.contigs = assemble(
                self.kmer_values,
                self.kmer_counts,
                self.clean_batch,
                cfg.kmer_size,
                min_contig_reads=cfg.min_contig_reads,
                min_contig_len=cfg.min_contig_len,
                contig_id_prefix=f"{self.target.name}_contig",
            )
            if cfg.olc_merge and len(self.contigs) > 1:
                # reference-parity contig consolidation (olc.py): two
                # contigs assembled from the two sides of one junction
                # fuse into one before realignment (SURVEY.md §2 #10)
                from breakmer_tpu_torch.assemble.olc import merge_contig_objects

                self.contigs = merge_contig_objects(
                    self.contigs, min_len=cfg.olc_min_overlap
                )
            if (cfg.contig_extension and self.contigs
                    and self.all_reads_provider is not None):
                # repeat-aware extension through ALL region reads: a
                # contig ending inside a tandem array gains the unique
                # flank that forces the absorbed indel representation
                # back out (assemble/extend.py; r5 TANDEM_FLOOR oracle)
                from breakmer_tpu_torch.assemble.extend import extend_contigs

                self.contigs = extend_contigs(
                    self.contigs, self.all_reads_provider,
                    anchor_k=cfg.extension_anchor_k,
                    max_grow=cfg.extension_max_grow,
                    region_codes=self.region_ref.codes,
                )
        return self.contigs

    def _coverage_at(self, chrom: str, pos: int) -> int:
        if self.extract_result is not None:
            depth = self.extract_result.coverage_at(chrom, pos)
            if depth:
                return depth
        if self.global_coverage_at is not None:
            return self.global_coverage_at(chrom, pos)
        return 0

    def _germline_kmer_test(self, ev: SVEvent, tables):
        """The recheck's k-mer test on the junction window: the raw-read
        k-mer subtraction is defeated when two sample reads share one
        sequencing error (see Config.germline_kmer_min rationale), but the
        assembled CONSENSUS is the clean germline sequence — so test whether
        the novel k-mers SPANNING THIS EVENT'S JUNCTION are carried by the
        normal. Windowing to the junction (deeply covered contig interior)
        keeps tail consensus errors and unrelated germline SNPs elsewhere in
        the contig from diluting the signal.

        Returns (reason, None) where the k-mers call the event germline,
        (None, None) where they cannot test it (no junction window, or no
        novel k-mer in it), and (None, (n_in, n_novel)) where they are
        inconclusive. None in the normal is inconclusive too: one consensus
        error at the junction's centre is in every k-mer of the window."""
        cfg = self.cfg
        if not ev.junction_q:
            return None, None
        from breakmer_tpu_torch.encode import encode_seq
        from breakmer_tpu_torch.ops.kmer import novel_kmer_normal_support

        ref_table, normal_table = tables
        k = cfg.kmer_size
        pad = k - 1
        lo = max(0, min(ev.junction_q) - pad)
        hi = min(len(ev.contig_seq), max(ev.junction_q) + pad)
        window = ev.contig_seq[lo:hi]
        if len(window) < k:
            return None, None
        n_novel, n_in = novel_kmer_normal_support(
            encode_seq(window), ref_table, normal_table, k, device=self.device
        )
        if (
            n_in >= cfg.germline_kmer_min
            and n_novel > 0
            and n_in / n_novel >= cfg.germline_kmer_frac
        ):
            return f"germline_kmer_support:{n_in}/{n_novel}", None
        if n_novel == 0:
            return None, None  # the window is the reference's: nothing to ask the normal
        return None, (n_in, n_novel)

    def _germline_recheck(self, events: List[SVEvent]) -> List[SVEvent]:
        """The events that the matched normal does not carry. An event is
        germline where the k-mer test says so or, where that test is
        inconclusive (the leaked contig's consensus carries the
        error-sharing reads' other errors, so exact k-mer membership
        under-counts), where a normal read carries its junction itself
        (``call/germline.py``). The alignments of all of the region's
        inconclusive events are made together. Counts go to METER.germline."""
        from breakmer_tpu_torch.call.germline import find_carriers, junction_query

        cfg = self.cfg
        tables = self._germline_tables() if events else None
        if tables is None:
            return events
        counts = Counter(events=len(events))
        unsure = []
        for ev in events:
            reason, kmers = self._germline_kmer_test(ev, tables)
            if reason is not None:
                ev.filter_reason = reason
                counts["germline_by_kmers"] += 1
                continue
            junction = kmers and junction_query(ev.contig_seq, ev.junction_q, cfg.kmer_size)
            if junction:
                unsure.append((ev, kmers, junction))
            else:
                counts["somatic_by_kmers"] += 1
        counts["kmers_inconclusive"] += len(unsure)
        if unsure:
            found = find_carriers([j for _, _, j in unsure], self.normal_batch, self.sw_params(),
                                  cfg.kmer_size, cfg.germline_sw_identity, device=self.device,
                                  counts=counts)
            for (ev, (n_in, n_novel), _), hit in zip(unsure, found):
                if hit is not None:
                    ev.filter_reason = (
                        f"germline_normal_junction:{hit.identity:.3f}@{hit.left}+{hit.right}"
                        f"(kmers {n_in}/{n_novel})"
                    )
                    counts["germline_by_alignment"] += 1
        kept = [ev for ev in events if ev.filter_reason is None]
        counts["kept"] += len(kept)
        METER.add_germline(counts)
        return kept

    def _germline_tables(self):
        cfg = self.cfg
        normal = self.normal_batch
        if normal is None or not len(normal):
            return None
        from breakmer_tpu_torch.ops.kmer import kmer_table

        k = cfg.kmer_size
        ref_table = kmer_table(
            self.region_ref.codes.reshape(1, -1),
            np.asarray([len(self.region_ref.codes)], dtype=np.int32), k,
            device=self.device,
        )
        normal_table = kmer_table(normal.codes, normal.lengths, k,
                                  device=self.device)
        return ref_table, normal_table

    def classify_contigs(self, segs_per_contig) -> RegionResult:
        cfg = self.cfg
        result = self._empty_result()
        result.contigs = self.contigs
        with METER.stage("classify"):
            for contig, segs in zip(self.contigs, segs_per_contig):
                if not segs:
                    continue
                events = classify_contig(
                    contig,
                    segs,
                    self.target.name,
                    cfg,
                    disc=(
                        self.disc_override
                        if self.disc_override is not None
                        else self.extract_result.disc if self.extract_result else None
                    ),
                    coverage_at=self._coverage_at,
                )
                result.all_events.extend(events)
            result.events = apply_filters(
                result.all_events, cfg, rmask=self.rmask, target=self.target,
                user_filter=self.user_filter,
            )
        if self.normal_batch is not None or cfg.normal_bam_file:
            # a span of its own after classify's, so that no two overlap
            with METER.stage("germline"):
                result.events = self._germline_recheck(result.events)
        if cfg.dedup_identical_events:
            with METER.stage("classify"):
                result.events = _dedup_identical(result.events)
        return result

    def resolve_sv(self) -> RegionResult:
        from breakmer_tpu_torch.align.realign import realign_contigs
        from breakmer_tpu_torch.encode import encode_seq

        contigs = self.assemble_contigs()
        if not contigs:
            return self._empty_result()
        # one device launch per round for ALL of this region's contigs
        segs_per_contig = realign_contigs(
            [(encode_seq(c.seq), self.region_ref) for c in contigs],
            genome=self.genome,
            params=self.sw_params(),
            **self.realign_opts(),
            device=self.device,
        )
        return self.classify_contigs(segs_per_contig)

    # -- one-call driver (reference: target.complete_analysis) -------------
    def run(
        self,
        records: Optional[Iterable[SamRecord]] = None,
        extract_result: Optional[ExtractResult] = None,
        extract: Optional[Callable[[], ExtractResult]] = None,
    ) -> RegionResult:
        """The region from its reads to its calls. ``extract`` makes the
        extraction (the runner's, from ``reads.py``) inside the region's
        fault isolation."""
        try:
            if extract is not None:
                extract_result = extract()
            if not self.find_sv_reads(records, extract_result):
                return RegionResult(
                    target=self.target,
                    events=[],
                    all_events=[],
                    contigs=[],
                    n_records=self.extract_result.n_records if self.extract_result else 0,
                    n_sv_reads=self.extract_result.n_sv_reads if self.extract_result else 0,
                    n_clean_reads=len(self.clean_batch) if self.clean_batch else 0,
                )
            return self.resolve_sv()
        except DEVICE_FAULTS:  # a kernel that failed, or a card in a fault: ends the run
            raise
        except Exception as exc:  # region-level fault isolation (SURVEY.md §5)
            log.exception("target %s failed", self.target.name)
            return RegionResult(
                target=self.target, events=[], all_events=[], contigs=[],
                error=f"{type(exc).__name__}: {exc}",
            )
