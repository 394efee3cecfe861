"""Run orchestrator / region scheduler.

Reference: sv_processor.py ``class runner`` (SURVEY.md §2 #3, §3.1):
parses the targets BED, prepares per-target reference data, iterates
targets (the reference forks a multiprocessing pool; the only parallelism
it has), and writes the aggregate ``output/<analysis_name>_svs.out``.

Differences by design: no gfServer to start (the genome index is an
in-memory object), reference data is cached as packed .npy artifacts
(content-addressed by region), and a per-region completion ledger enables
resume at region granularity (SURVEY.md §5 checkpoint/resume).

Port of breakmer_tpu/runner.py. Device-level data parallelism over
regions lives in parallel/: the batched path's packed k-mer launches
shard over a mesh of the process's local devices
(``device.local_devices``) when it has more than one, and so does the
genome seed table with ``shard_genome_index``; ``multihost`` partitions
targets across processes and process 0 merges their ledger shards. The
reference's Pool(nprocs) maps to nprocs host worker THREADS over the
batched path's host stages (extract / assemble / classify), with every
cross-region ordering decision kept on the main thread so nprocs>1
output is byte-identical to nprocs=1. ``Config.device`` picks the torch
device of the k-mer and SW stages (breakmer_tpu_torch.device). Where the
sample's and the normal's reads come from is ``reads.py``'s decision.
"""

from __future__ import annotations

import contextlib
import functools
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from breakmer_tpu_torch._build import DEVICE_FAULTS
from breakmer_tpu_torch.align.index import GenomeIndex, is_saved
from breakmer_tpu_torch.align.realign import RegionRef
from breakmer_tpu_torch.call.events import SVEvent
from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.encode import ReadBatch
from breakmer_tpu_torch.io.bed import TargetRegion, read_targets_bed
from breakmer_tpu_torch.io.fasta import FastaIndex
from breakmer_tpu_torch.pipeline import RegionResult, TargetPipeline
from breakmer_tpu_torch.reads import open_normal_reads, open_sample_reads
from breakmer_tpu_torch.report import event_row, write_svs_rows
from breakmer_tpu_torch.utils.logging import get_logger, setup_logger
from breakmer_tpu_torch.utils.meter import METER
from breakmer_tpu_torch.utils.rmask import RepeatMask

log = get_logger("runner")


class Runner:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.targets: Dict[str, TargetRegion] = {}
        self.fasta: Optional[FastaIndex] = None
        self.genome: Optional[GenomeIndex] = None
        self.rmask: Optional[RepeatMask] = None
        self.results: List[RegionResult] = []
        self.other_regions: Dict[str, TargetRegion] = {}
        self.user_filter: Optional[RepeatMask] = None
        self.reads = None  # the sample's reads (reads.open_sample_reads), chosen once
        self.normal_reads = None  # the normal's (reads.open_normal_reads), closed after a run
        self.total_calls = 0  # rows in the aggregate output (incl. resumed)
        self.kmer_pipeline = None  # the batched run's KmerBatchPipeline

    # -- setup (reference: runner.__init__ + start_blat_server) ------------
    def setup(self) -> None:
        """Everything a sample's regions need, in METER spans: ``setup``
        (the inputs, then the filters) with ``index_load`` (the genome
        index) between."""
        METER.reset()  # this sample's counters (-> metrics.json), set-up included
        METER.owner = self
        with METER.stage("setup"):
            self._open_inputs()
        with METER.stage("index_load"):
            self._load_genome_index()
        with METER.stage("setup"):
            self._load_filters()

    def _open_inputs(self) -> None:
        cfg = self.cfg
        cfg.validate()
        setup_logger(cfg.analysis_dir, cfg.log_level)
        self.process_index, self.process_count = 0, 1
        if cfg.multihost:
            from breakmer_tpu_torch.parallel.multihost import init_distributed

            self.process_index, self.process_count = init_distributed(
                cfg.coordinator_address, cfg.num_processes, cfg.process_id
            )
        from breakmer_tpu_torch.device import resolve

        self.device = resolve(cfg.device)
        log.info("compute device: %s", self.device)
        gene_list = None
        if cfg.gene_list:
            gene_list = [g.strip() for g in Path(cfg.gene_list).read_text().split()]
        self.targets = read_targets_bed(cfg.targets_bed_file, gene_list)
        self.all_target_names = list(self.targets)
        if cfg.multihost:
            from breakmer_tpu_torch.parallel.multihost import partition_targets
            mine = set(partition_targets(
                self.all_target_names, self.process_index, self.process_count
            ))
            self.targets = {n: t for n, t in self.targets.items() if n in mine}
            log.info(
                "multihost: process %d/%d owns %d of %d targets",
                self.process_index, self.process_count,
                len(self.targets), len(self.all_target_names),
            )
        if str(cfg.reference_fasta).endswith(".2bit"):
            # UCSC .2bit references accepted directly (migration compat
            # with the reference's faToTwoBit artifacts)
            from breakmer_tpu_torch.io.twobit import TwoBitReader

            self.fasta = TwoBitReader(cfg.reference_fasta)
        else:
            self.fasta = FastaIndex(cfg.reference_fasta)

    def _load_genome_index(self) -> None:
        cfg = self.cfg
        if cfg.build_genome_index:
            # gfServer replacement: a whole-genome seed index, cached as a
            # directory of arrays under reference_data_dir (the formalized
            # .2bit equivalent; SURVEY.md §5) that each sample maps
            t0 = time.time()
            cache = legacy = None
            if cfg.reference_data_dir:
                ref_dir = Path(cfg.reference_data_dir)
                ref_dir.mkdir(parents=True, exist_ok=True)
                stem = f"{Path(cfg.reference_fasta).stem}_genome_index"
                cache = ref_dir / f"{stem}_v3_k{cfg.seed_kmer_size}"
                legacy = ref_dir / f"{stem}_v2_k{cfg.seed_kmer_size}.npz"
            if cache is not None and is_saved(cache):
                source = "mapped"
            elif legacy is not None and legacy.exists():
                # an earlier version's cache: converted once; the .npz stays
                # for the checkouts that still read it
                GenomeIndex.load(legacy).save(cache)
                source = "converted"
            else:
                # generator, not to_dict(): only one chromosome's unpacked
                # sequence is alive at a time during the build (the index
                # keeps everything 2-bit packed; genome-scale RAM budget)
                self.genome = GenomeIndex(
                    ((n, self.fasta.fetch_codes(n, 0, self.fasta.length(n)))
                     for n in self.fasta.names),
                    cfg.seed_kmer_size,
                )
                if cache is not None:
                    self.genome.save(cache)
                source = "built"
            if source != "built":
                self.genome = GenomeIndex.load(cache)
            METER.index = {"source": source, "bytes": int(self.genome.nbytes)}
            log.info("genome index %s (%s) in %.1fs", source, cache, time.time() - t0)
        if self.genome is not None and cfg.shard_genome_index:
            from breakmer_tpu_torch.device import local_devices

            devices = local_devices(cfg.device)
            if len(devices) > 1:
                # local devices only: each process owns a full copy of the
                # index sharded over its own devices (regions are already
                # process-partitioned; no cross-process lookup traffic)
                from breakmer_tpu_torch.parallel.index_shard import (
                    ShardedGenomeIndex, make_shard_mesh,
                )

                self.genome = ShardedGenomeIndex(
                    self.genome, make_shard_mesh(devices=devices))
                log.info(
                    "genome seed table sharded over %d devices",
                    self.genome.mesh.devices.size,
                )
            else:
                log.info("shard_genome_index requested but only 1 device; "
                         "keeping the replicated index")

    def _load_filters(self) -> None:
        cfg = self.cfg
        if cfg.repeat_mask_file:
            self.rmask = RepeatMask.from_bed(cfg.repeat_mask_file)
        if cfg.other_regions_file:
            self.other_regions = read_targets_bed(cfg.other_regions_file)
        if cfg.filter_list:
            # user filter_list: calls with breakpoints in these intervals
            # are suppressed (reference: sv_caller filter_list)
            self.user_filter = RepeatMask.from_bed(cfg.filter_list)

    # -- reference data (reference: preset_ref_data / set_ref_data) --------
    def region_ref(self, target: TargetRegion) -> RegionRef:
        cfg = self.cfg
        chrom, start, end = target.span(cfg.region_buffer)
        cache_dir = Path(cfg.reference_data_dir) if cfg.reference_data_dir else None
        if cache_dir:
            cache_dir.mkdir(parents=True, exist_ok=True)
            key = f"{target.name}_{chrom}_{start}_{end}_codes.npy"
            fp = cache_dir / key
            if fp.exists():
                codes = np.load(fp)
                return RegionRef.build(chrom, start, codes, cfg.seed_kmer_size)
        codes = self.fasta.fetch_codes(chrom, start, end)
        if cache_dir:
            np.save(cache_dir / key, codes)
        return RegionRef.build(chrom, start, codes, cfg.seed_kmer_size)

    def preset_ref_data(self) -> None:
        """Build all region caches up front (reference preset mode,
        SURVEY.md §3.4)."""
        for target in self.targets.values():
            self.region_ref(target)

    # -- ledger (checkpoint/resume, SURVEY.md §5) --------------------------
    @property
    def _ledger_path(self) -> Path:
        if self.cfg.multihost:
            from breakmer_tpu_torch.parallel.multihost import shard_ledger_path

            return shard_ledger_path(self.cfg.analysis_dir, self.process_index)
        return Path(self.cfg.analysis_dir) / "ledger.json"

    @property
    def _ledger_append_path(self) -> Path:
        return self._ledger_path.with_suffix(".jsonl")

    def _load_ledger(self) -> Dict[str, dict]:
        """Snapshot overlaid with the append log (crash-safe resume)."""
        ledger: Dict[str, dict] = {}
        if self._ledger_path.exists():
            ledger = json.loads(self._ledger_path.read_text())
        ap = self._ledger_append_path
        if ap.exists():
            for line in ap.read_text().splitlines():
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail line from a crash mid-append
                ledger[rec["name"]] = rec["entry"]
        return ledger

    def _append_ledger(self, name: str, entry: dict) -> None:
        """O(1) per-region checkpoint: one JSON line appended. Rewriting
        the whole ledger per region was O(panel^2) and measured at 35% of
        a 100-gene warm run; the consolidated ledger.json is written once
        at finalize."""
        self._ledger_path.parent.mkdir(parents=True, exist_ok=True)
        with open(self._ledger_append_path, "a") as fh:
            fh.write(json.dumps({"name": name, "entry": entry}) + "\n")

    def _save_ledger(self, ledger: Dict[str, dict]) -> None:
        self._ledger_path.parent.mkdir(parents=True, exist_ok=True)
        self._ledger_path.write_text(json.dumps(ledger, indent=1))
        self._ledger_append_path.unlink(missing_ok=True)

    # -- per-target intermediates (reference keeps these as the de-facto
    # debugging fixtures: sv fastq, kmer dumps, contig fastas — SURVEY.md §4)
    def _write_intermediates(self, name: str, pipe: TargetPipeline, result) -> None:
        from breakmer_tpu_torch.io.fastq import write_fastq
        from breakmer_tpu_torch.ops.kmer import kmer_to_str

        base = Path(self.cfg.analysis_dir) / "targets" / name
        (base / "data").mkdir(parents=True, exist_ok=True)
        (base / "kmers").mkdir(exist_ok=True)
        (base / "contigs").mkdir(exist_ok=True)
        if pipe.extract_result is not None and len(pipe.extract_result.batch):
            write_fastq(base / "data" / "sv_reads.fastq", pipe.extract_result.batch)
        if pipe.clean_batch is not None and len(pipe.clean_batch):
            write_fastq(base / "data" / "clean_reads.fastq", pipe.clean_batch)
        if pipe.kmer_values is not None and len(pipe.kmer_values):
            k = self.cfg.kmer_size
            with open(base / "kmers" / "sample_kmers.out", "w") as fh:
                for v, c in zip(pipe.kmer_values, pipe.kmer_counts):
                    fh.write(f"{kmer_to_str(int(v), k)}\t{int(c)}\n")
        if result.contigs:
            from breakmer_tpu_torch.io.fasta import write_fasta

            write_fasta(
                base / "contigs" / "contigs.fa",
                {c.id: c.seq for c in result.contigs},
            )

    # -- a region's inputs: its reference, the normal's reads, the sample's reads
    def _normal_batch(self, target: TargetRegion) -> Optional[ReadBatch]:
        """The normal's reads over a region (``reads.NormalReads``), None
        where the sample has no normal."""
        if not self.cfg.normal_bam_file:
            return None
        if self.normal_reads is None:
            self.normal_reads = open_normal_reads(self.cfg)
        return self.normal_reads.batch(target)

    def _region_pipeline(self, target: TargetRegion) -> TargetPipeline:
        """A region's pipeline: its reference and its normal's reads, each in
        its METER span (``normal_reads`` only where the sample has a normal),
        wired to the sample's reads."""
        cfg, reads = self.cfg, self.reads
        with METER.stage("region_ref"):
            region_ref = self.region_ref(target)
        normal_batch = None
        if cfg.normal_bam_file:
            with METER.stage("normal_reads"):
                normal_batch = self._normal_batch(target)
        return TargetPipeline(
            cfg, target, region_ref, genome=self.genome, rmask=self.rmask,
            normal_batch=normal_batch, device=self.device,
            coverage_at=reads.depth_at, user_filter=self.user_filter,
            all_reads=functools.partial(reads.all_reads, target),
            disc_override=reads.discordant_pairs() if cfg.global_disc_support else None,
        )

    def _pending(self, ledger: Dict[str, dict]):
        """(name, target) of each target the ledger does not hold yet."""
        for name, target in self.targets.items():
            if name in ledger:
                log.info("target %s: resumed from ledger (%d calls)",
                         name, len(ledger[name].get("rows", [])))
            else:
                yield name, target

    # -- main loop (reference: runner.run) ---------------------------------
    def run(self, resume: bool = False) -> List[SVEvent]:
        cfg = self.cfg
        if not self.targets:
            self.setup()
        if METER.owner is not self:  # the set-up METER holds is another run's
            METER.reset()
        METER.owner = None  # a second run() of this Runner meters itself alone
        if self.reads is None:
            self.reads = open_sample_reads(cfg)
        try:
            if cfg.batch_regions:
                return self._run_batched(resume)
            return self._run_serial(resume)
        finally:
            if self.normal_reads is not None:
                self.normal_reads.close()
            self.normal_reads = None
            if cfg.multihost:
                from breakmer_tpu_torch.parallel.multihost import shutdown_distributed

                shutdown_distributed()

    def _run_serial(self, resume: bool) -> List[SVEvent]:
        ledger = self._load_ledger() if resume else {}
        all_events: List[SVEvent] = []
        t_start = time.time()
        for name, target in self._pending(ledger):
            t0 = time.perf_counter()
            pipe = self._region_pipeline(target)
            result = pipe.run(extract=functools.partial(self.reads.extract, target))
            all_events += self._record_region(ledger, name, pipe, result, t0)
        return self._finalize(ledger, all_events, t_start)

    def _record_region(self, ledger: Dict[str, dict], name: str, pipe: TargetPipeline,
                       result: RegionResult, since: float) -> List[SVEvent]:
        """A finished region into the ledger, in the ``ledger`` span: its
        rows, VCF records, error, stats and the seconds since ``since`` (on
        ``time.perf_counter``). Returns its calls."""
        with METER.stage("ledger"):
            self._annotate_other_regions(result.events)
            if self.cfg.keep_intermediates:
                self._write_intermediates(name, pipe, result)
            self.results.append(result)
            log.info(
                "target %s: %d records, %d sv reads, %d kmers, %d contigs, "
                "%d calls (%d pre-filter) in %.2fs%s",
                name, result.n_records, result.n_sv_reads,
                result.n_sample_kmers, len(result.contigs),
                len(result.events), len(result.all_events),
                time.perf_counter() - since,
                f" ERROR={result.error}" if result.error else "",
            )
            ledger[name] = {
                "rows": [event_row(ev) for ev in result.events],
                "vcf": self._vcf_records(name, result.events),
                "error": result.error,
                "elapsed_s": round(time.perf_counter() - since, 6),
                "stats": _region_stats(result),
            }
            self._append_ledger(name, ledger[name])
        return result.events

    def _vcf_records(self, region: str, events: List[SVEvent]) -> List[dict]:
        """VCF record dicts for a region's calls, stored in the ledger so
        resumed regions keep their VCF rows (breakmer_tpu/vcf.py)."""
        from breakmer_tpu_torch.vcf import event_vcf_records

        ref_base_at = None
        if self.fasta is not None:
            ref_base_at = lambda c, p: self.fasta.fetch(c, p - 1, p)
        recs: List[dict] = []
        for i, ev in enumerate(events, 1):
            rid = f"{self.cfg.analysis_name}_{region}_{i}"
            recs.extend(event_vcf_records(ev, rid, ref_base_at))
        return recs

    def _run_batched(self, resume: bool) -> List[SVEvent]:
        """Config #3 path: the whole panel's k-mer stage in packed
        multi-region device launches (parallel/kmer_batch), then per-region
        assemble/realign/call. A matched normal rides in the same packed
        launches (RegionBatch.normal_reads; in-device subtraction —
        batched ≡ serial calls, cross-tested)."""
        from breakmer_tpu_torch.parallel.kmer_batch import KmerBatchPipeline

        cfg = self.cfg
        ledger = self._load_ledger() if resume else {}
        all_events: List[SVEvent] = []
        t_start = time.time()

        # device mesh decided up front so packed k-mer launches can
        # dispatch DURING extraction — sharded over the local device mesh
        # when more than one device is attached
        from breakmer_tpu_torch.device import local_devices

        mesh = None
        # LOCAL devices only: regions are already partitioned across
        # processes at the host level (multihost model), so each process
        # shards its own batches over its own devices
        devices = local_devices(cfg.device)
        if len(devices) > 1:
            from breakmer_tpu_torch.parallel.mesh import make_mesh_2d

            mesh = make_mesh_2d(devices=devices)
            log.info(
                "kmer batch sharded over %d devices (%s)",
                mesh.devices.size, "x".join(map(str, mesh.devices.shape)),
            )
        # batch G must divide evenly over the mesh regions axis
        rpb = max(1, int(cfg.kmer_regions_per_batch or 32))
        if mesh is not None:
            r_axis = mesh.devices.shape[0]
            rpb = r_axis * max(1, rpb // r_axis)
        kb = KmerBatchPipeline(
            cfg.kmer_size, cfg.min_kmer_count, mesh=mesh, regions_per_batch=rpb,
            device=None if mesh is not None else self.device,
        )
        self.kmer_pipeline = kb
        pipes = {name: self._region_pipeline(target) for name, target in self._pending(ledger)}
        order = list(pipes)

        # host worker pool (reference parity: runner.run forks a
        # Pool(nprocs) over targets — SURVEY.md §2 #19). Here the device
        # already batches across regions, so nprocs threads parallelize
        # the HOST stages only: per-region extraction/cleaning, assembly,
        # and classification. Threads, not processes: the hot host work is
        # numpy/ctypes (GIL released), and per-region state stays shared.
        # Determinism: results are per-region and every cross-region
        # ordering decision (kb.add packing order, realign item order,
        # ledger append order) is made on the main thread in target order,
        # so nprocs>1 output is byte-identical to nprocs=1 (tested).
        nprocs = max(1, int(cfg.nprocs or 1))
        with _ordered_map(nprocs) as ordered_map:
            # phase A: extract + clean every region (host, streaming); full
            # tier groups dispatch their device launch immediately, so the
            # k-mer stage runs under the remaining extraction (VERDICT r1 #4)
            def extract_one(name: str) -> bool:
                pipe = pipes[name]
                return pipe.extract_and_clean(extract_result=self.reads.extract(pipe.target))

            if nprocs > 1 and order:
                self.reads.prewarm()  # shared state exists BEFORE workers read it
            for name, found in zip(order, ordered_map(extract_one, order)):
                if found:  # kb.add in target order: deterministic
                    pipe = pipes[name]
                    kb.add(name, pipe.clean_batch, pipe.region_ref.codes, pipe.normal_batch)

            # phase B/C overlap: assemble each batch's regions as its fetch
            # lands while later batches still run on device; then realign
            # EVERY contig of the panel in lockstep batched device launches
            from breakmer_tpu_torch.encode import encode_seq
            from breakmer_tpu_torch.align.realign import realign_contigs

            t0c = time.time()
            items = []
            item_owner = []

            def assemble_one(name: str) -> list:
                """Per-region assembly; returns this region's realign items so
                the main thread appends them in deterministic target order."""
                pipe, out = pipes[name], []
                try:
                    for contig in pipe.assemble_contigs():
                        out.append((encode_seq(contig.seq), pipe.region_ref))
                except DEVICE_FAULTS:  # ends the run, as in TargetPipeline.run
                    raise
                except Exception as exc:
                    log.exception("target %s assembly failed", name)
                    pipe.contigs = []
                    pipe._assembly_error = f"{type(exc).__name__}: {exc}"
                return out

            def assemble(names: List[str]) -> None:
                for name, region_items in zip(names, ordered_map(assemble_one, names)):
                    items.extend(region_items)
                    item_owner.extend([name] * len(region_items))

            assembled = set()
            for region_kmers in kb.results():
                for name, vc in region_kmers.items():
                    pipes[name].set_kmers(*vc)
                assemble(list(region_kmers))
                assembled.update(region_kmers)
            assemble([name for name in order if name not in assembled])  # no kmers -> empty
            log.info("kmer batch: %d packed launches, %d overflow refetches",
                     kb.dispatched, kb.refetched)
            segs_all = []
            if items:
                any_pipe = next(iter(pipes.values()))
                segs_all = realign_contigs(
                    items, genome=self.genome, params=any_pipe.sw_params(),
                    **any_pipe.realign_opts(), device=self.device,
                )
            log.info(
                "panel realign: %d contigs in %.2fs", len(items), time.time() - t0c
            )
            segs_by_region: Dict[str, list] = {name: [] for name in pipes}
            for owner, segs in zip(item_owner, segs_all):
                segs_by_region[owner].append(segs)

            def classify_one(name: str):
                t0 = time.perf_counter()
                pipe = pipes[name]
                try:
                    if getattr(pipe, "_assembly_error", None):
                        raise RuntimeError(pipe._assembly_error)
                    result = pipe.classify_contigs(segs_by_region[name])
                except DEVICE_FAULTS:  # ends the run, as in TargetPipeline.run
                    raise
                except Exception as exc:  # region-level fault isolation
                    log.exception("target %s failed", name)
                    result = RegionResult(
                        target=pipe.target, events=[], all_events=[], contigs=[],
                        error=f"{type(exc).__name__}: {exc}",
                    )
                return result, time.perf_counter() - t0

            # without a pool each region is classified just before its ledger entry
            for name, (result, dt) in zip(order, ordered_map(classify_one, order)):
                all_events += self._record_region(ledger, name, pipes[name], result,
                                                  time.perf_counter() - dt)
        return self._finalize(ledger, all_events, t_start)

    def _annotate_other_regions(self, events: List[SVEvent]) -> None:
        """Annotate events whose breakpoints fall in ``other_regions_file``
        entries (reference: other-regions handling in runner/target —
        SURVEY.md §2 #16): the partner locus name joins the genes column,
        e.g. a translocation into an off-target partner gene."""
        if not self.other_regions:
            return
        for ev in events:
            extra = []
            for chrom, start, _end in ev.breakpoints:
                for name, reg in self.other_regions.items():
                    if (
                        name != ev.genes
                        and name not in extra
                        and reg.chrom == chrom
                        and reg.start <= start < reg.end
                    ):
                        extra.append(name)
            if extra:
                ev.genes = ",".join([ev.genes] + extra)

    def _finalize(self, ledger, all_events, t_start) -> List[SVEvent]:
        cfg = self.cfg
        if cfg.multihost and self.process_index != 0:
            log.info("multihost: worker %d done (%d targets); process 0 "
                     "merges the output", self.process_index, len(self.targets))
            return all_events
        with METER.stage("finalize"):
            if cfg.multihost:
                from breakmer_tpu_torch.parallel.multihost import merge_ledger_shards

                ledger = merge_ledger_shards(
                    cfg.analysis_dir, self.all_target_names, self.process_count
                )
            self._save_ledger(ledger if not cfg.multihost else self._load_ledger())
            # aggregate from the ledger so resumed targets keep their calls
            order = self.all_target_names if cfg.multihost else list(self.targets)
            all_rows = [
                row for name in order for row in ledger.get(name, {}).get("rows", [])
            ]
            out = Path(cfg.analysis_dir) / "output" / f"{cfg.analysis_name}_svs.out"
            write_svs_rows(out, all_rows)
            self.total_calls = len(all_rows)
            from breakmer_tpu_torch.vcf import write_vcf

            vcf_recs = [
                rec for name in order for rec in ledger.get(name, {}).get("vcf", [])
            ]
            contigs = (
                [(n, self.fasta.length(n)) for n in self.fasta.names]
                if self.fasta is not None else []
            )
            write_vcf(
                Path(cfg.analysis_dir) / "output" / f"{cfg.analysis_name}.vcf",
                vcf_recs, contigs=contigs, sample=cfg.analysis_name,
                reference=cfg.reference_fasta,
            )
        # structured per-stage counters (SURVEY.md §5 observability — the
        # reference exposes these only as log prose)
        metrics = {
            "targets": len(order),
            "calls": len(all_rows),
            "elapsed_s": round(time.time() - t_start, 3),
            # per-stage wall seconds + run-level SW GCUPS (SURVEY.md §5:
            # the reference logs only elapsed-time prose; GCUPS is the
            # BASELINE.json required kernel metric)
            **METER.snapshot(),
            "errors": {
                n: ledger[n]["error"]
                for n in order
                if ledger.get(n, {}).get("error")
            },
            "regions": {
                n: {**ledger[n].get("stats", {}),
                    "calls": len(ledger[n].get("rows", [])),
                    "elapsed_s": ledger[n].get("elapsed_s")}
                for n in order if n in ledger
            },
        }
        (Path(cfg.analysis_dir) / "metrics.json").write_text(
            json.dumps(metrics, indent=1)
        )
        log.info(
            "run complete: %d targets, %d calls (%d new) in %.1fs -> %s",
            len(self.targets), len(all_rows), len(all_events),
            time.time() - t_start, out,
        )
        return all_events


def _region_stats(result: RegionResult) -> dict:
    return {
        "records": result.n_records,
        "sv_reads": result.n_sv_reads,
        "clean_reads": result.n_clean_reads,
        "sample_kmers": result.n_sample_kmers,
        "contigs": len(result.contigs),
        "prefilter_events": len(result.all_events),
        "filter_reasons": [
            ev.filter_reason for ev in result.all_events if ev.filter_reason
        ],
    }


@contextlib.contextmanager
def _ordered_map(nprocs: int):
    """``map`` for one process, else the map of a pool of ``nprocs``
    threads; either yields results in the order of its inputs."""
    if nprocs <= 1:
        yield map
        return
    from concurrent.futures import ThreadPoolExecutor

    log.info("host worker pool: %d threads", nprocs)
    with ThreadPoolExecutor(max_workers=nprocs) as pool:
        yield pool.map
