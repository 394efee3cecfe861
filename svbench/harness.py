"""One run of one cell: set-up, the measured window, the reading of the
trace and the check of what the window produced.

The loop is closed: one client runs one sample at a time, each a fresh
``breakmer_tpu_torch.runner.Runner`` over its own BAM, and waits for its
calls. The window opens when the first sample starts and closes when the
first ``Runner.run()`` that ends at or after ``--seconds`` returns, so it
holds whole samples only; ``regions_per_s`` is the regions those calls
completed over the window's length.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from svbench.gen.bam import write_bam
from svbench.gen.genome import Genome, GenomeSpec, make_panel, write_2bit, write_bed
from svbench.gen.sample import Sample, SampleMaker, make_sample
from svbench.gen.truth import check_sample

PKG = Path(__file__).resolve().parent
REPO = PKG.parent
CACHE = PKG / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "breakmer_tpu")
WARMUP_TARGETS = 4
SW_PAIRS_CHECKED = 16  # pairs of a captured SW call held to the reference, drawn from the seed


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"svbench: no workload {name!r} in BENCHMARK.json")


def cell_files(cell: dict) -> tuple:
    """The configuration, the traffic mix and the limits of a cell, each
    found by name."""
    cfg = load_json(PKG / "configs" / f"{cell['config']}.json")
    mix = load_json(PKG / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(PKG / "limits" / f"{cell['name']}.json")
    return cfg, mix, limits


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def rehearsal_config(cfg: dict) -> dict:
    """The same configuration at a size the CPU runs in seconds. Its window
    holds one sample of a few targets, so ``rehearsal_limits`` asks of its
    counts only that they are not nought."""
    cfg = json.loads(json.dumps(cfg))
    cfg["genome"].update(total_bp=6_000_000, chromosomes=4)
    cfg["panel"].update(targets=6, edge=200_000)
    cfg["reads"]["depth"] = 30
    if cfg.get("normal"):
        cfg["normal"]["depth"] = 15
    return cfg


def rehearsal_limits(limits: dict) -> dict:
    return {k: ({"at_least": min(1, v["at_least"])} if isinstance(v, dict) else v) for k, v in limits.items()}


def card_missing(chips: int) -> Optional[str]:
    """Why a measured run cannot run here, or None: it needs ``chips``
    CUDA cards and never falls back to the CPU."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return None if n >= chips else f"needs {chips} CUDA card(s); found {n}"


# -- the genome cache ------------------------------------------------------
def ensure_genome(genome: Genome, panel_bed: Path, device: str) -> Path:
    """``svbench/.cache/genome-<key>/`` with the genome's .2bit and the
    program's own seed index of it, built once (by ``Runner.setup``) and
    moved into place whole, so a run cut short leaves no half cache."""
    final = CACHE / f"genome-{genome.spec.key}"
    if (final / "READY").exists():
        return final
    stage = CACHE / f"genome-{genome.spec.key}.partial"
    shutil.rmtree(stage, ignore_errors=True)
    stage.mkdir(parents=True)
    write_2bit(stage / "genome.2bit", genome)
    (stage / "none.bam").touch()  # the set-up checks that a sample is named
    from breakmer_tpu_torch.config import Config
    from breakmer_tpu_torch.runner import Runner

    Runner(Config(analysis_dir=str(stage / "build"), targets_bed_file=str(panel_bed),
                  reference_fasta=str(stage / "genome.2bit"), reference_data_dir=str(stage),
                  sample_bam_file=str(stage / "none.bam"), device=device)).setup()
    shutil.rmtree(stage / "build", ignore_errors=True)
    (stage / "none.bam").unlink()
    (stage / "READY").write_text(genome.spec.key + "\n")
    shutil.rmtree(final, ignore_errors=True)
    os.replace(stage, final)
    return final


# -- what the window drives, recorded around the layers' entry points -------
class Recorder:
    """The benchmark's own spans around calls into the program: the shapes
    of every SW and k-mer call (for the rooflines), a sample of their
    inputs and outputs drawn from the seed (for the references), and,
    in a traced run, a profiler label for every METER stage and sample.
    ``fault`` plants one of the test faults under the timed path; the
    faults "sw_unhooked" and "kmer_unhooked" leave a layer's calls unseen,
    as a program that routes around these entry points would."""

    def __init__(self, seed: int, trace: bool, fault: Optional[str] = None,
                 sw_keep: int = 48, kmer_keep: int = 24):
        self.seed = seed
        self.rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
        self.trace = trace
        self.fault = fault
        self.sw_keep, self.kmer_keep = sw_keep, kmer_keep
        self.active = False
        self.sw_calls: List[tuple] = []
        self.kmer_calls: List[tuple] = []
        self.sw_capture: List[dict] = []
        self.kmer_capture: List[dict] = []
        self._kb_inputs: Dict[str, dict] = {}
        self._kb_shapes: Dict[str, tuple] = {}
        self.sw_largest: Optional[dict] = None  # the window's largest SW call, always checked
        self._sw_largest = -1
        self._undo: List[tuple] = []

    def _patch(self, owner, name: str, new) -> None:
        self._undo.append((owner, name, name in vars(owner), getattr(owner, name)))
        setattr(owner, name, new)

    def install(self) -> None:
        from breakmer_tpu_torch import pipeline
        from breakmer_tpu_torch.align import realign
        from breakmer_tpu_torch.parallel.kmer_batch import KmerBatchPipeline
        from breakmer_tpu_torch.pipeline import TargetPipeline
        from breakmer_tpu_torch.runner import Runner
        from breakmer_tpu_torch.utils.meter import METER

        rec = self
        sw_orig, kmer_orig = realign.sw_score_batch, pipeline.sample_only_kmers
        add_orig, set_orig = KmerBatchPipeline.add, TargetPipeline.set_kmers
        stage_orig, run_orig = METER.stage, Runner.run

        def sw_score_batch(q, t, params, no_n=False, *, device):
            out = sw_orig(q, t, params, no_n=no_n, device=device)
            if rec.active:
                out = rec._on_sw(q, t, params, out)
            return out

        def sample_only_kmers(sample_codes, sample_lengths, ref_codes, k, normal_codes=None,
                              normal_lengths=None, min_count=2, *, device):
            args = (sample_codes, sample_lengths, ref_codes, k, normal_codes, normal_lengths, min_count)
            run_args = rec._fault_kmer_args(args) if rec.active else args
            v, c = kmer_orig(*run_args, device=device)
            if rec.active:
                v, c = rec._on_kmer(args, v, c)
            return v, c

        def add(kb, name, batch, ref, normal=None):
            if rec.active:
                rec._on_kb_add(name, batch, ref, normal, kb)
                batch, normal = rec._fault_batch(batch, normal)
            return add_orig(kb, name, batch, ref, normal)

        def set_kmers(pipe, values, counts):
            if rec.active:
                values, counts = rec._on_set_kmers(pipe, values, counts)
            return set_orig(pipe, values, counts)

        if self.fault != "sw_unhooked":
            self._patch(realign, "sw_score_batch", sw_score_batch)
        if self.fault != "kmer_unhooked":
            self._patch(pipeline, "sample_only_kmers", sample_only_kmers)
            self._patch(KmerBatchPipeline, "add", add)
            self._patch(TargetPipeline, "set_kmers", set_kmers)
        if self.fault == "normal_left_out":  # the matched normal never reaches the caller
            self._patch(Runner, "_normal_batch", lambda runner, target: None)
        if self.fault == "region_raises":
            def raising(pipe, *a, **kw):
                raise RuntimeError("planted fault")
            self._patch(TargetPipeline, "assemble_contigs", raising)
        if self.trace:
            from torch.profiler import record_function

            def stage(name):
                return _Both(record_function(f"svbench.stage.{name}"), stage_orig(name))

            def run(runner, *a, **kw):
                with record_function("svbench.sample"):
                    return run_orig(runner, *a, **kw)

            self._patch(METER, "stage", stage)
            self._patch(Runner, "run", run)

    def uninstall(self) -> None:
        for owner, name, had, old in reversed(self._undo):
            if had:
                setattr(owner, name, old)
            else:
                delattr(owner, name)
        self._undo.clear()

    # -- SW -----------------------------------------------------------------
    def _on_sw(self, q, t, params, out):
        q, t = np.asarray(q), np.asarray(t)
        lq, lt = (q < 4).sum(axis=1), (t < 4).sum(axis=1)
        cells = int((lq.astype(np.int64) * lt).sum())
        self.sw_calls.append((q.shape[0], q.shape[1], t.shape[1], cells, int(lq.sum() + lt.sum())))
        if self.fault == "sw_answer" and len(out[0]):
            out = (out[0].copy(), out[1], out[2])
            out[0][0] += 1
        if self.fault == "sw_half":
            h = len(out[0]) // 2
            out = tuple(np.array(o) for o in out)
            out[0][h:], out[1][h:], out[2][h:] = 0, -1, -1
        take = len(self.sw_capture) < self.sw_keep and (not self.sw_capture or self.rng.random() < 0.35)
        if take or cells > self._sw_largest:
            entry = {"q": q.copy(), "t": t.copy(), "params": tuple(params[:4]),
                     "out": tuple(np.asarray(o).copy() for o in out), "cells": cells}
            if take:
                self.sw_capture.append(entry)
            if cells > self._sw_largest:
                self._sw_largest, self.sw_largest = cells, entry
        return out

    # -- k-mers ---------------------------------------------------------------
    def _fault_kmer_args(self, args):
        if self.fault == "kmer_half":
            s, ln = args[0], args[1]
            h = max(1, len(ln) // 2)
            return (s[:h], ln[:h]) + args[2:]
        return args

    def _fault_batch(self, batch, normal):
        if self.fault == "kmer_half" and len(batch) > 1:
            from breakmer_tpu_torch.encode import ReadBatch

            h = len(batch) // 2
            batch = ReadBatch(batch.codes[:h], batch.lengths[:h], list(batch.names[:h]),
                              None if batch.quals is None else batch.quals[:h])
        return batch, normal

    def _windows(self, lengths, k) -> int:
        return int(np.clip(np.asarray(lengths, dtype=np.int64) - k + 1, 0, None).sum())

    def _work(self, sample_lengths, ref_len, normal_lengths, k) -> tuple:
        n_len = normal_lengths if normal_lengths is not None else []
        windows = self._windows(sample_lengths, k) + self._windows([ref_len], k) + self._windows(n_len, k)
        return windows, int(np.sum(sample_lengths)) + ref_len + int(np.sum(n_len))

    def _on_kmer(self, args, v, c):
        s, ln, ref, k, nc, nl, mc = args
        self.kmer_calls.append(self._work(ln, int(np.asarray(ref).size), nl, k) + (len(v),))
        if self.fault == "kmer_answer" and len(c):
            c = c.copy()
            c[0] += 1
        if len(self.kmer_capture) < self.kmer_keep and (not self.kmer_capture or self.rng.random() < 0.25):
            self.kmer_capture.append({
                "sample": np.array(s), "lengths": np.array(ln), "ref": np.array(ref), "k": int(k),
                "normal": None if nc is None else np.array(nc), "normal_lengths": None if nl is None else np.array(nl),
                "min_count": int(mc), "values": np.array(v), "counts": np.array(c)})
        return v, c

    def _on_kb_add(self, name, batch, ref, normal, kb) -> None:
        nl = normal.lengths if normal is not None and len(normal) else None
        self._kb_shapes[name] = self._work(batch.lengths, int(np.asarray(ref).size), nl, kb.k)
        held = len(self.kmer_capture) + len(self._kb_inputs)
        if held < self.kmer_keep and (not held or self.rng.random() < 0.25):
            self._kb_inputs[name] = {
                "sample": np.array(batch.codes), "lengths": np.array(batch.lengths), "ref": np.array(ref),
                "k": int(kb.k), "normal": None if nl is None else np.array(normal.codes),
                "normal_lengths": None if nl is None else np.array(nl), "min_count": int(kb.min_count)}

    def _on_set_kmers(self, pipe, values, counts):
        if self.fault == "kmer_answer" and len(counts):
            counts = np.array(counts)
            counts[0] += 1
        shape = self._kb_shapes.pop(pipe.target.name, None)
        if shape is not None:
            self.kmer_calls.append(shape + (len(values),))
        entry = self._kb_inputs.pop(pipe.target.name, None)
        if entry is not None:
            entry.update(values=np.array(values), counts=np.array(counts))
            self.kmer_capture.append(entry)
        return values, counts

    def end_pass(self) -> None:
        self._kb_inputs.clear()
        self._kb_shapes.clear()


class _Both:
    def __init__(self, a, b):
        self.a, self.b = a, b

    def __enter__(self):
        self.a.__enter__()
        return self.b.__enter__()

    def __exit__(self, *exc):
        try:
            return self.b.__exit__(*exc)
        finally:
            self.a.__exit__(*exc)


# -- samples ----------------------------------------------------------------
@dataclasses.dataclass
class Prepared:
    sample: Sample
    tumour_bam: Path
    normal_bam: Optional[Path]


def prepare_samples(maker: SampleMaker, genome: Genome, seed: int, work: Path, n: int) -> List[Prepared]:
    refs = [(c, genome.lengths[c]) for c in genome.names]
    out = []
    for i in range(n):
        s = make_sample(maker, seed, i)
        tb = work / f"{s.name}.tumour.bam"
        write_bam(tb, refs, s.tumour, f"{s.name}t")
        nb = None
        if s.normal is not None:
            nb = work / f"{s.name}.normal.bam"
            write_bam(nb, refs, s.normal, f"{s.name}n")
        s.tumour = s.normal = None  # the BAMs hold the reads now
        out.append(Prepared(s, tb, nb))
    return out


def runner_config(cfg: dict, p: Prepared, genome_dir: Path, bed: Path, analysis: Path, device: str,
                  gene_list: Optional[Path] = None):
    from breakmer_tpu_torch.config import Config

    r = cfg["runner"]
    return Config(
        analysis_name=p.sample.name, analysis_dir=str(analysis), targets_bed_file=str(bed),
        reference_fasta=str(genome_dir / "genome.2bit"), reference_data_dir=str(genome_dir),
        sample_bam_file=str(p.tumour_bam), normal_bam_file=str(p.normal_bam) if p.normal_bam else None,
        gene_list=str(gene_list) if gene_list else None, device=device,
        batch_regions=bool(r["batch_regions"]), nprocs=int(r["nprocs"]),
        kmer_regions_per_batch=int(r["kmer_regions_per_batch"]))


def run_pass(cfg: dict, p: Prepared, genome_dir: Path, bed: Path, analysis: Path, device: str,
             gene_list: Optional[Path] = None) -> dict:
    """One sample through a fresh Runner; its wall and what metrics.json
    says of it."""
    from breakmer_tpu_torch.runner import Runner

    conf = runner_config(cfg, p, genome_dir, bed, analysis, device, gene_list)
    t0 = time.perf_counter()
    Runner(conf).run()
    t1 = time.perf_counter()
    m = load_json(analysis / "metrics.json")
    regions = m.get("regions", {})
    return {"t0": t0, "t1": t1, "wall": t1 - t0, "sample": p.sample.name, "targets": m.get("targets", 0),
            "completed": sum(1 for n, r in regions.items() if n not in m.get("errors", {})),
            "errors": len(m.get("errors", {})), "stage_s": m.get("stage_s", {}),
            "region_s": [r.get("elapsed_s") for r in regions.values() if r.get("elapsed_s") is not None],
            "vcf": str(analysis / "output" / f"{p.sample.name}.vcf")}


# -- correctness ------------------------------------------------------------
def check_outputs(rec: Recorder, passes: List[dict], prepared: Dict[str, Prepared], genome: Genome,
                  limits: dict, control: Optional[str] = None) -> Dict[str, dict]:
    """Every number compared, with its limit: at most the limit, or, where
    the limits file gives ``{"at_least": n}``, at least n (the SW calls and
    k-mer sets held to the references, so that a window that captured none
    is not correct). ``control`` reads a
    control in the program's place: "kmer_table_16" and "sw_int16" the
    references at the precision below (tables held at 16 bits, scores
    saturating at 16 bits), "pos_16bit" the written calls with their
    coordinates held at 16 bits (the breakpoint guarantee broken)."""
    from svbench.reference.kmer import sample_only
    from svbench.reference.sw import sw

    planted = missed = germ = germ_called = false = calls = 0
    missed_msgs: List[str] = []
    for p in passes:
        svs = prepared[p["sample"]].sample.svs
        r = check_sample(svs, Path(p["vcf"]), genome, pos_bits=16 if control == "pos_16bit" else 0)
        planted += r["somatic"]
        missed += len(r["missed"])
        missed_msgs += r["missed"]
        germ += r["germline"]
        germ_called += len(r["germline_called"])
        false += len(r["false_calls"])
        calls += r["calls"]
    kmer_bad = 0
    for c in rec.kmer_capture:
        want = sample_only(c["sample"], c["lengths"], c["ref"], c["k"], c["normal"], c["normal_lengths"],
                           c["min_count"])
        got = (c["values"], c["counts"])
        if control == "kmer_table_16":
            got = sample_only(c["sample"], c["lengths"], c["ref"], c["k"], c["normal"], c["normal_lengths"],
                              c["min_count"], table_bits=16)
        same = len(want[0]) == len(got[0]) and (np.asarray(got[0]) == want[0]).all() and \
            (np.asarray(got[1]) == want[1]).all()
        kmer_bad += not same
    sw_bad = 0
    sw_list = list(rec.sw_capture)
    if rec.sw_largest is not None and all(e is not rec.sw_largest for e in sw_list):
        sw_list.append(rec.sw_largest)
    pick = np.random.default_rng(np.random.SeedSequence([rec.seed, 11]))
    for c in sw_list:
        rows = np.arange(len(c["q"]))
        if len(rows) > SW_PAIRS_CHECKED:
            rows = np.sort(pick.choice(rows, SW_PAIRS_CHECKED, replace=False))
        want = sw(c["q"][rows], c["t"][rows], *c["params"])
        got = tuple(np.asarray(o)[rows] for o in c["out"])
        if control == "sw_int16":
            got = sw(c["q"][rows], c["t"][rows], *c["params"], bits=16)
        bad = np.zeros(len(want[0]), dtype=bool)
        for g, w in zip(got, want):
            bad |= np.asarray(g) != w
        sw_bad += int(bad.sum())
    region_errors = sum(p["targets"] - p["completed"] for p in passes)
    values = {
        "region_errors": float(region_errors),
        "sv_missed_pct": 100.0 * missed / planted if planted else 0.0,
        "germline_called": float(germ_called),
        "kmer_sets_wrong": float(kmer_bad),
        "sw_pairs_wrong": float(sw_bad),
        "sw_calls_checked": float(len(sw_list)),
        "kmer_sets_checked": float(len(rec.kmer_capture)),
    }
    out = {}
    for k, v in values.items():
        lim = limits.get(k)
        if isinstance(lim, dict):
            out[k] = {"value": v, "limit": lim["at_least"], "at_least": True}
        elif lim is not None:
            out[k] = {"value": v, "limit": lim}
    out["_detail"] = {"planted": planted, "germline": germ, "calls": calls, "false_calls": false,
                      "missed": missed_msgs[:8]}
    return out


def within(check: dict) -> bool:
    return check["value"] >= check["limit"] if check.get("at_least") else check["value"] <= check["limit"]


def check_line(name: str, check: dict) -> str:
    return f"check {name}: {check['value']} ({'at least' if check.get('at_least') else 'limit'} {check['limit']})"


# -- the run ------------------------------------------------------------------
def read_metrics(names: List[str], record: dict) -> Dict[str, dict]:
    """Each metric by its own reader ``svbench/metrics/<name>.py``; a
    reader that finds nothing returns None and the metric is left out."""
    out = {}
    for name, unit in names:
        mod = importlib.import_module(f"svbench.metrics.{name}")
        v = mod.read(record)
        if v is not None:
            out[name] = {"value": v, "unit": unit}
    return out


def peak_rss_bytes() -> int:
    """The process's peak resident set (getrusage's ru_maxrss, in KiB on Linux)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def device_memory_bytes(torch) -> int:
    """The larger of the caching allocator's peak and what the card holds
    for this process now (the kernels' own scratch and the context too)."""
    free, total = torch.cuda.mem_get_info()
    return max(int(torch.cuda.max_memory_reserved()), int(total - free))


class CellRun:
    """A cell's set-up for one seed (the genome cache, the panel, the two
    samples, the region references, the warm-up), then one or more
    windows over it and the checks of what each produced."""

    def __init__(self, cell: dict, seed: int, *, rehearse: bool = False):
        self.cell, self.seed = cell, seed
        self.cpu = rehearse
        self.device = "cpu" if rehearse else "cuda"
        self.cfg, self.mix, self.limits = cell_files(cell)
        if rehearse:
            self.cfg = rehearsal_config(self.cfg)
            self.limits = rehearsal_limits(self.limits)
        self.genome = Genome(GenomeSpec.from_config(self.cfg["genome"]))
        self.panel = make_panel(self.genome, self.cfg["panel"])
        CACHE.mkdir(parents=True, exist_ok=True)
        self.work = Path(tempfile.mkdtemp(prefix="svbench-"))
        self.windows = 0

    def close(self) -> None:
        shutil.rmtree(self.work, ignore_errors=True)

    def setup(self) -> None:
        cfg, work = self.cfg, self.work
        self.start_peak_rss = peak_rss_bytes()
        self.bed = work / "targets.bed"
        write_bed(self.bed, self.panel)
        self._prepare_in_child()
        self.by_name = {p.sample.name: p for p in self.prepared}
        import torch

        from breakmer_tpu_torch.runner import Runner

        warm = work / "warm.txt"
        warm.write_text("\n".join(t.name for t in self.panel[:WARMUP_TARGETS]) + "\n")
        preset = Runner(runner_config(cfg, self.prepared[0], self.genome_dir, self.bed, work / "preset",
                                      self.device))
        preset.setup()
        preset.preset_ref_data()
        del preset
        for i, p in enumerate(self.prepared):
            run_pass(cfg, p, self.genome_dir, self.bed, work / f"warm{i}", self.device, gene_list=warm)
        if not self.cpu:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.setup_peak_rss = peak_rss_bytes()

    def _prepare_in_child(self) -> None:
        """The genome cache and the samples by ``svbench.prepare``, in a
        process of its own that has ended before the program runs here."""
        plan = self.work / "plan.json"
        plan.write_text(json.dumps({"cfg": self.cfg, "mix": self.mix, "seed": self.seed, "work": str(self.work),
                                    "bed": str(self.bed), "device": self.device}))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        out = subprocess.run([sys.executable, "-m", "svbench.prepare", str(plan)], cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        sys.stderr.write(out.stdout)
        if out.returncode:
            raise RuntimeError(f"svbench.prepare exited {out.returncode}")
        with open(self.work / "prepared.pkl", "rb") as fh:
            got = pickle.load(fh)
        self.genome_dir, self.prepared, self.gen_s = Path(got["genome_dir"]), got["prepared"], got["gen_s"]

    def window(self, seconds: float, trace: bool, fault: Optional[str] = None, min_passes: int = 1) -> dict:
        """Samples in turn until one ends at or after ``seconds`` (and at
        least ``min_passes`` ran); the window's record."""
        import torch

        rec = Recorder(self.seed, trace, fault)
        rec.install()
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([] if self.cpu else [ProfilerActivity.CUDA])
            prof = profile(activities=acts)
            prof.__enter__()
        passes: List[dict] = []
        w = self.windows
        self.windows += 1
        rec.active = True
        w0 = time.perf_counter()
        try:
            i = 0
            while True:
                p = self.prepared[i % len(self.prepared)]
                passes.append(run_pass(self.cfg, p, self.genome_dir, self.bed, self.work / f"w{w}pass{i}",
                                       self.device))
                rec.end_pass()
                i += 1
                if passes[-1]["t1"] - w0 >= seconds and i >= min_passes:
                    break
            if not self.cpu:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - w0
        finally:
            rec.active = False
            events = None
            if prof is not None:
                prof.__exit__(None, None, None)
                events = prof.profiler.kineto_results.events()
            rec.uninstall()
        from svbench import trace as tr

        return {"cfg": self.cfg, "passes": passes, "window_s": window_s,
                "peak_rss_bytes": peak_rss_bytes(), "dev_peak": 0 if self.cpu else device_memory_bytes(torch),
                "trace": tr.summarize(events, window_s) if events is not None else None,
                "sw_calls": rec.sw_calls, "kmer_calls": rec.kmer_calls, "recorder": rec,
                "device_name": None if self.cpu else torch.cuda.get_device_name(0)}

    def check(self, record: dict, control: Optional[str] = None) -> tuple:
        checks = check_outputs(record["recorder"], record["passes"], self.by_name, self.genome, self.limits,
                               control)
        return checks, checks.pop("_detail")


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, *, t_start: float, rehearse: bool = False,
             fault: Optional[str] = None, control: Optional[str] = None) -> dict:
    """One run: set-up, one window, then the checks once the window has
    closed and memory has been read."""
    run = CellRun(cell, seed, rehearse=rehearse)
    try:
        run.setup()
        setup_s = time.time() - t_start
        record = run.window(seconds, trace, fault)
        record["setup_s"] = setup_s
        record["peak_rss_by_phase"] = {"imports": run.start_peak_rss, "setup": run.setup_peak_rss}
        checks, detail = run.check(record, control)
        passes = record["passes"]
        return {"record": record, "checks": checks, "detail": detail,
                "attempted": sum(p["targets"] for p in passes),
                "failed": sum(p["targets"] - p["completed"] for p in passes),
                "gen_s": run.gen_s, "dev_peak": record["dev_peak"]}
    finally:
        run.close()
