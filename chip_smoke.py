"""Smoke run of the PyTorch/CUDA port (breakmer_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line; each
phase's wall time is printed):
  1. environment: torch, CUDA, the card's name and power limit;
  2. build the CUDA kernels from csrc/ (one nvcc a source, in parallel);
  3. the SW kernel against the plain torch version on the card, bit-exact
     at the shapes realign produces, with no_n off and on, ~1% N and
     custom scoring (one set past the packed row key's range), at the
     launch plan's form and rows a lane and at each R of both forms
     (ticket: 4, 8; block: 2) forced, packed and unpacked; median of 5
     CUDA-event timings of each (of the plain version: at the headline
     shape; one timing elsewhere), with GCUPS, the bound and the share of
     it the kernel reaches; the serial path's largest shapes (1x256x512,
     1x256x1024, 12x512x1024) in both forms, exact, then timed in turns;
     the step-cost table behind the plan's clock model; one pair at each
     of realign's pad tiers at every R of both forms;
  4. the k-mer engine on the card against the CPU (2,000 x 150 bp reads,
     3 kb region, matched normal: the plan's route, a cluster of 16 CTAs,
     and the per-function route forced); then each of the four k-mer kernels
     (csrc/kmer.cu) and the both-strand form of revcomp_kmers against its
     plain version, exact, at a serial region's shapes and the batch
     step's (unique_counts_sorted on tiled errored reads and on random
     reads), with its device time (queued calls), a call's time, the
     plain version's, the bound and one torch call's where one computes
     the same function; each at its designs' span and tile edges; the
     region kernel (csrc/region_kmers.cu, a serial region's whole
     sample_only_kmers in one launch of a thread-block cluster) exact
     against the plain chain on every region case of tools/kmer_time.py
     (each through the plan's route, and forced at each cluster size the
     card runs that takes it; one read either side of the first design's
     limit and of the plan's), timed at the serial shape at the plan's
     cluster size and at one block, with its phase clocks; and the CUDA
     kernels one sample_only_kmers call runs
     (profiler, in a fresh process, on the plan's route and on the
     per-function route forced, and in this one, each hand kernel's
     activities beside its launches: the fresh process must see every
     launch, and one launch of the region kernel alone on the plan's);
  5. the serial slice on the card (python -m breakmer_tpu_torch.cli run,
     driven as the CLI drives it) on scenario seeds 1 and 7: every
     planted-SV checker must pass;
  6. the slice at panel scale: a 100-gene errored panel with a matched
     normal, on the card and then on the CPU; svs.out and the VCF must be
     byte-identical, no region may fail, every SW batch of the card run
     must have launched the kernel, one region kernel launch a fused
     region, the per-function kernels on per-function regions alone
     (kmer_codes also for a germline recheck), and at least one SW launch must
     have taken the block form (1x256x512 and 1x256x1024 every time),
     each counted under the form its plan chose; a second card run
     records the SW launches by shape, each replayed for its kernel time
     in its own form and in the ticket form, in turns, beside its bound
     (the timed run records nothing); then every region's recorded k-mer
     call through the region kernel, exact against the plain chain, and
     the routes and cluster sizes of the panel's regions, of bench_panel's
     20 genes and of tools/bench_panel_scaling's two deep tiers at 100
     genes, each run serially on the card (their fused regions exact too);
  7. the probe kernels against their plain versions on the card, exact:
     the stripped SW loop in both forms at steps 1, 7, 255 and the
     default, every int16 op of both int16 probes, the running max; each
     kernel's device time (queued calls) and a call's time beside its
     bound; the ceiling probe's rolls0 and roll_bound_fraction against the
     SW kernel; the int16 probe's launch path step by step (1,000 calls a
     step); every int16 op with a one-call torch counterpart timed against
     it in turns (kernel, torch, torch, kernel); the running max against
     torch.cummax in turns at [8, 256], its launch path step by step, and
     at [16384, 1024] and [65536, 256] exact, with its device time against
     torch.cummax's and the bound, at each warps a block;
  8. the batched panel path on the same 100-gene panel (batch_regions,
     32 regions a packed k-mer launch) on the card, nprocs 1 (cold, then
     warm) and 4: svs.out and the VCF byte-identical to phase 6's serial
     output, no region error, every SW batch launched the kernel, every
     per-function k-mer kernel launched and the region kernel no time,
     the SW launches counted by form; then a
     recorded warm run gives the SW launches by shape and form as in
     phase 6;
  9. the k-mer batch step on the card against the CPU, exact, full and
     packed, at 32 regions of 512 reads with a matched normal; both
     timed with their fetch;
 10. the region step on the card against the CPU, exact, at the bench's
     shape;
 11. the measurement path, as a user runs it: python -m
     breakmer_tpu_torch.bench, the ceiling probe and the three probes of
     breakmer_tpu_torch.tools, then python -m
     breakmer_tpu_torch.bench_panel; each probe kernel must have
     launched;
 12. the region step over a virtual (2, 2) mesh on the card (each shard
     on cuda:0), exact against the unsharded CUDA step and the CPU step
     at the bench's shape, one SW launch a shard; both forms timed;
 13. the k-mer batch step of phase 9 over the same mesh, full and
     packed, exact against the unsharded CUDA step and the CPU step;
 14. the batched runner on the 100-gene panel under
     ``device.virtual_devices([cuda:0] * 4)`` (its k-mer launches
     through a (2, 2) mesh), byte-identical to phase 6's serial output;
 15. a seed table of a 24-chromosome, ~300 Mbp genome sharded over
     [cuda:0] * 4 and [cuda:0]: 2,000 contigs' candidate windows equal
     GenomeIndex.candidates; then the runner with shard_genome_index on
     the 100-gene panel, byte-identical to phase 6;
 16. multihost: two processes on the card (a gloo rendezvous on
     127.0.0.1) run the 100-gene panel over their round-robin halves;
     process 0's merged svs.out and VCF are byte-identical to phase 6's;
 17. the tools: gpu_agreement in full (the SW kernel against the plain
     version on the pad-tier and strip-boundary cases, every launch
     form and R): 0 mismatches, one SW launch a case, path and form;
 18. sweep_accuracy --genome repeats --seeds 8 --fp 4 on the card and on
     the CPU: the two records equal apart from wall_s;
 19. probe_fetch: one fetch of n buffers against n fetches, pageable and
     pinned; its JSON line;
 20. bench_genome_e2e at 100 Mbp on the card: ins, del and trl called,
     the warm run (index artifact reloaded) equal to the cold one.
 21. the entry points of __graft_entry__.py, ported as
     breakmer_tpu_torch.graft_entry:
     entry()'s step on the card, called with no argument, exact against
     entry("cpu") on its example arguments and on tiled reads at its
     shapes, one launch of each kernel a step (two of kmer_codes), timed
     by CUDA events and by queued calls; then dryrun_multichip(4) over
     [cuda:0] * 4 (the sharded step, one SW launch a shard; the sharded
     seed table; the batched runner over the mesh against the serial
     one), its wall time and each stage's launches.
 22. the k-mer engine over its input domain (testing/kmer_domain.py: k
     from -2 to 17 crossed with the edges of each input): on every case
     K1, K2 in both forms, the per-function route forced, the region
     kernel forced to each cluster size that takes the case and the
     plan's route, exact against the plain versions on the card, each
     launch counted (at k <= 0 the region kernel at every cluster size the
     card runs); then scenario seed 1 (two genes, a matched normal) at
     kmer_size = seed_kmer_size = 0, serial and batched, on the card and
     on the CPU: svs.out, the VCF and the ledger rows byte-identical, no
     region error, the counts set to 0 before each card run and read
     after it (the serial run one region kernel launch a region, the
     batched run every per-function kernel).
 23. the SW engine over its input domain (testing/sw_domain.py: signed
     and large scoring parameters, the parent's limits among them,
     crossed with the edges of the shapes and codes, Lt of 2^16 and 2^16
     + 1 and queries of 2,049 and 10,240 rows among them): on every case
     the kernel at the plan's form, R, pack and no_n and at every R
     forced, packed and unpacked, exact against the plain version on the
     card, each launch counted by form, a refusal only past the TPU
     kernel's score limit and at Lq = 0, before any launch; then seed 1
     at gap_open_pen = gap_extend_pen = 1,000,000, serial and batched, on
     the card and on the CPU: svs.out, the VCF and the ledger rows
     byte-identical, no region error, the SW launches by form read after
     each card run.
The last two lines are the kernel table (with each kernel's bound and
the time of one PyTorch call computing the same function, null where
there is none) and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX, of the JAX package or of the tests.

The bound of a kernel is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the
card's peak for their type: SMs * 64 int32 lanes * the SM's maximum clock
(``nvidia-smi --query-gpu=clocks.max.sm``), twice that for int16 ops
packed two to a lane.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

# "python3 dir/chip_smoke.py" puts dir on sys.path, not the working
# directory: the port is found from the checkout the script is run in
sys.path.insert(0, os.getcwd())
import breakmer_tpu_torch  # noqa: E402

ROOT = Path(breakmer_tpu_torch.__file__).resolve().parent.parent
WORK = ROOT / "build" / "chip_smoke"
SW_SHAPES = [(512, 256, 512), (301, 128, 256), (37, 1024, 2048), (16, 1024, 6144),
             (8, 3072, 2048), (64, 512, 16384), (2, 10240, 2048)]
HEADLINE = (512, 256, 512)
# the serial path's two largest launch shapes and its widest, each run in
# both forms of the SW kernel in turns
SW_FORM_SHAPES = [(1, 256, 512), (1, 256, 1024), (12, 512, 1024)]
CI_KINDS = {1: ["ins", "del", "dup", None], 7: ["inv", "trl", None, None]}
OUTPUTS = ("prop_svs.out", "prop.vcf")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
SW_OPS = 7  # integer-pipe operations a cell (csrc/sw_wavefront.cu's note)
_PEAK = {}


def int32_ops_per_s() -> float:
    """SMs * 64 int32 lanes * the SM's maximum clock (nvidia-smi)."""
    if not _PEAK:
        import subprocess

        mhz = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _PEAK.update(sms=sms, mhz=float(mhz), ops=sms * 64 * float(mhz) * 1e6)
    return _PEAK["ops"]


def bound(nbytes: float, int32_ops: float = 0.0, int16_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak for their type."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = (int32_ops + int16_ops / 2) / int32_ops_per_s() * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")


def sw_bound(B, Lq, Lt):
    return bound(B * (Lq + Lt) + 12 * B, int32_ops=B * Lq * Lt * SW_OPS)


def sw_inputs(rng, B, Lq, Lt, n_rate=0.0):
    """Random codes with exact copies of the query planted in every third
    target and a ragged trailing pad; ``n_rate`` adds mid-sequence N."""
    q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.int8)
    for b in range(0, B, 3):
        n = int(rng.integers(min(Lq, Lt) // 4, min(Lq, Lt) // 2 + 1))
        at = int(rng.integers(0, Lt - n + 1))
        t[b, at:at + n] = q[b, :n]
    q_len = rng.integers(Lq // 2, Lq + 1, B)
    t_len = rng.integers(Lt // 2, Lt + 1, B)
    q[np.arange(Lq)[None, :] >= q_len[:, None]] = 4
    t[np.arange(Lt)[None, :] >= t_len[:, None]] = 4
    if n_rate:
        q[(rng.random(q.shape) < n_rate) & (q < 4)] = 4
        t[(rng.random(t.shape) < n_rate) & (t < 4)] = 4
    return q, t


def sw_max_err(ref, got) -> int:
    return max(int((a.long() - b.long()).abs().max()) for a, b in zip(ref, got))


def phase_sw(dev, card):
    from breakmer_tpu_torch.ops import sw_cuda
    from breakmer_tpu_torch.ops.sw import SWParams, sw_score
    from breakmer_tpu_torch.timing import cuda_ms, device_us, queued_ms

    rng = np.random.default_rng(2024)
    max_err = 0
    rows = []
    int32_ops_per_s()
    print(f"  int32 peak {_PEAK['sms']} SMs x 64 x {_PEAK['mhz']:.0f} MHz = "
          f"{_PEAK['ops'] / 1e12:.3f} T ops/s; SW bound at {SW_OPS} ops a cell", flush=True)
    t_shapes = time.perf_counter()
    for B, Lq, Lt in SW_SHAPES:
        t_shape = time.perf_counter()
        cases = [("planted", 0.0, SWParams(), (False, True)),
                 ("1% N", 0.01, SWParams(), (False,)),
                 ("params 3,2,4,2", 0.0, SWParams(3, 2, 4, 2), (False, True)),
                 # the plan keeps score and column apart where 16 min(Lq, Lt) >= 2^15
                 ("params 16,12,20,8", 0.0, SWParams(16, 12, 20, 8), (False, True))]
        for label, n_rate, params, no_n_forms in cases:
            q, t = (torch.from_numpy(a).to(dev) for a in sw_inputs(rng, B, Lq, Lt, n_rate))
            ref = sw_score(q, t, params)
            for no_n in no_n_forms:
                got = sw_cuda.sw_score_cuda(q, t, params, no_n=no_n)
                torch.cuda.synchronize()
                err = sw_max_err(ref, got)
                max_err = max(max_err, err)
                check(err == 0, f"SW kernel != plain at {(B, Lq, Lt)} {label} no_n={no_n}")
        q, t = (torch.from_numpy(a).to(dev) for a in sw_inputs(rng, B, Lq, Lt))
        ref = sw_score(q, t)
        by_r = {}  # device ms at each rows-a-lane, after an exact check
        for R in sw_cuda.ROWS_PER_LANE + sw_cuda.BLOCK_ROWS_PER_LANE:
            if not sw_cuda._fits(R, Lq, Lt):
                continue
            for unpacked in (False, True):
                err = sw_max_err(ref, sw_cuda.sw_score_cuda(q, t, no_n=True, rows_per_lane=R,
                                                            unpacked=unpacked))
                max_err = max(max_err, err)
                check(err == 0, f"SW kernel (R={R}, unpacked={unpacked}) != plain at "
                                f"{(B, Lq, Lt)}")
            by_r[R] = queued_ms(lambda: sw_cuda.sw_score_cuda(
                q, t, no_n=True, rows_per_lane=R), n=10)
        plan = sw_cuda.launch_plan(B, Lq, Lt, sms=_PEAK["sms"])
        k_ms = cuda_ms(lambda: sw_cuda.sw_score_cuda(q, t, no_n=True))
        d_ms = queued_ms(lambda: sw_cuda.sw_score_cuda(q, t, no_n=True), n=10)
        # the plain version's time: five calls at the headline shape, one
        # elsewhere (each takes seconds at the large shapes)
        p_ms = cuda_ms(lambda: sw_score(q, t)) if (B, Lq, Lt) == HEADLINE else once_ms(
            lambda: sw_score(q, t))
        if (B, Lq, Lt) == HEADLINE:  # the profiler's reading of a ctypes launch
            prof_ms = device_us(lambda: sw_cuda.sw_score_cuda(q, t, no_n=True), n=20) / 1e3
            print(f"  SW {B}x{Lq}x{Lt}: device ms, torch.profiler (timing.device_us) "
                  f"{prof_ms:.4f}, queued events {d_ms:.4f} [{card}]", flush=True)
        cells = B * Lq * Lt
        b_ms, b_by = sw_bound(B, Lq, Lt)
        rows.append(dict(shape=[B, Lq, Lt], ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                         profiler_device_ms=prof_ms if (B, Lq, Lt) == HEADLINE else None,
                         bound_ms=b_ms, bound_by=b_by, form=plan.form,
                         rows_per_lane=plan.rows_per_lane,
                         strips=plan.strips, device_ms_by_rows_per_lane=by_r,
                         gcups=cells / k_ms / 1e6, plain_gcups=cells / p_ms / 1e6))
        print(f"  SW {B}x{Lq}x{Lt}: exact; kernel {k_ms:.4f} ms a call, {d_ms:.4f} ms "
              f"on the device ({cells / k_ms / 1e6:.2f} GCUPS a call; {plan.form} "
              f"form, R={plan.rows_per_lane}, "
              f"{plan.strips} strips, {plan.warps} warps), bound {b_ms:.4f} ms "
              f"({b_by}), {b_ms / d_ms:.1%} of the bound on the device; device ms by R "
              + ", ".join(f"{R}: {ms:.4f}" for R, ms in by_r.items())
              + f"; plain {p_ms:.2f} ms ({cells / p_ms / 1e6:.4f} GCUPS); "
              f"{time.perf_counter() - t_shape:.1f} s [{card}]", flush=True)
    t_parts = {"shapes": time.perf_counter() - t_shapes}
    t0 = time.perf_counter()
    turns = sw_form_turns(dev, card, rng)
    max_err = max([max_err] + [r["max_abs_err"] for r in turns])
    t_parts["form turns"], t0 = time.perf_counter() - t0, time.perf_counter()
    step_cycles = sw_step_costs(dev, card)
    t_parts["step costs"], t0 = time.perf_counter() - t0, time.perf_counter()
    tiers = sw_tier_grid(dev, card, rng)
    torch.cuda.synchronize()
    t_parts["tier grid"] = time.perf_counter() - t0
    print("  SW phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in t_parts.items()),
          flush=True)
    return rows, max_err, dict(form_turns=turns, step_cycles=step_cycles, tier_grid=tiers)


def once_ms(fn) -> float:
    """One call of fn() between two CUDA events, in ms."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def sw_tier_grid(dev, card, rng):
    """One pair at each of realign's pad tiers (Lq 128-1024 x Lt
    256-2048; a serial launch's pairs each take an SM, so one pair times
    1-12): device ms at every R of both forms, beside the R the plan picks
    and the R the ticket form alone would pick (the plan before the block
    form existed)."""
    from breakmer_tpu_torch.ops import sw_cuda
    from breakmer_tpu_torch.timing import queued_ms

    rows = []
    for Lq in (128, 256, 512, 1024):
        for Lt in (256, 512, 1024, 2048):
            q, t = (torch.from_numpy(a).to(dev) for a in sw_inputs(rng, 1, Lq, Lt))
            ms = {R: queued_ms(lambda: sw_cuda.sw_score_cuda(q, t, no_n=True, rows_per_lane=R),
                               n=10)
                  for R in sw_cuda.ROWS_PER_LANE + sw_cuda.BLOCK_ROWS_PER_LANE}
            plan = sw_cuda.launch_plan(1, Lq, Lt, sms=_PEAK["sms"]).rows_per_lane
            ticket = sw_cuda._rows_per_lane(1, Lq, Lt, _PEAK["sms"])
            rows.append(dict(shape=[1, Lq, Lt], device_ms_by_rows_per_lane=ms, plan=plan,
                             ticket=ticket))
            print(f"  SW tier 1x{Lq}x{Lt}: device ms by R "
                  + ", ".join(f"{R}: {x:.4f}" for R, x in ms.items())
                  + f"; plan R={plan} ({ms[plan] / ms[ticket]:.3f}x the ticket form's R={ticket}),"
                  f" fastest R={min(ms, key=ms.get)} [{card}]", flush=True)
    return rows


def sw_form_turns(dev, card, rng):
    """SW_FORM_SHAPES in both forms of the kernel (each form at the R the
    plan picks within it), exact against the plain version (no_n off and
    on, packed and unpacked), then timed in turns (block, ticket, ticket,
    block): device ms of queued calls and ms a call (CUDA events)."""
    from breakmer_tpu_torch.ops import sw_cuda
    from breakmer_tpu_torch.ops.sw import sw_score
    from breakmer_tpu_torch.timing import cuda_ms, queued_ms

    rows = []
    for B, Lq, Lt in SW_FORM_SHAPES:
        q, t = (torch.from_numpy(a).to(dev) for a in sw_inputs(rng, B, Lq, Lt))
        ref = sw_score(q, t)
        # each form at the R its clock model picks within it
        rows_of = {form: sw_cuda._rows_per_lane(B, Lq, Lt, _PEAK["sms"], rs)
                   for form, rs in sw_cuda.FORMS.items()}
        err = 0
        for R in rows_of.values():
            for no_n in (False, True):
                for unpacked in (False, True):
                    err = max(err, sw_max_err(ref, sw_cuda.sw_score_cuda(
                        q, t, no_n=no_n, unpacked=unpacked, rows_per_lane=R)))
        check(err == 0, f"SW kernel forms != plain at {(B, Lq, Lt)}")
        dev_ms = {form: [] for form in sw_cuda.FORMS}
        call_ms = {form: [] for form in sw_cuda.FORMS}
        for form in ("block", "ticket", "ticket", "block"):
            run = lambda: sw_cuda.sw_score_cuda(  # noqa: E731
                q, t, no_n=True, rows_per_lane=rows_of[form])
            dev_ms[form].append(queued_ms(run, n=10))
            call_ms[form].append(cuda_ms(run))
        b_ms, b_by = sw_bound(B, Lq, Lt)
        plan = sw_cuda.launch_plan(B, Lq, Lt, sms=_PEAK["sms"])
        forms = {form: dict(rows_per_lane=rows_of[form],
                            device_ms=dev_ms[form], ms=call_ms[form],
                            bound_share=b_ms / min(dev_ms[form]))
                 for form in sw_cuda.FORMS}
        rows.append(dict(shape=[B, Lq, Lt], plan_form=plan.form, max_abs_err=err,
                         bound_ms=b_ms, bound_by=b_by, forms=forms))
        print(f"  SW forms {B}x{Lq}x{Lt}: exact; plan takes {plan.form} R={plan.rows_per_lane}; "
              + "; ".join(f"{form} R={r['rows_per_lane']}: device "
                          + ", ".join(f"{x:.4f}" for x in r["device_ms"]) + " ms, a call "
                          + ", ".join(f"{x:.4f}" for x in r["ms"])
                          + f" ms, {r['bound_share']:.1%} of the bound"
                          for form, r in forms.items())
              + f"; bound {b_ms:.4f} ms ({b_by}) [{card}]", flush=True)
    return rows


def sw_step_costs(dev, card):
    """The table behind ops/sw_cuda.py's STEP_CYCLES (device time of queued
    launches). Ticket form, at each R: clocks a step of one strip of
    32 R x 4096 with 1, 2 and 4 warps a SM partition, and the steps one
    pair of 8 strips over 2048 columns takes past one strip, a strip.
    Block form, at each R: clocks a column of one pair of 4 strips (a warp
    a partition) and of 16 strips (their slope from 512 to 2048 columns;
    a warp's share is a quarter of the latter), and the steps each strip
    after the first adds at 4 strips over 512 columns. Returns {R: (alone,
    shared, lag)}."""
    from breakmer_tpu_torch.ops import sw_cuda
    from breakmer_tpu_torch.timing import queued_ms

    rng = np.random.default_rng(5)
    hz = _PEAK["mhz"] * 1e6
    codes = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.integers(0, 4, shape).astype(np.int8)).to(dev)
    table = {}
    for R in sw_cuda.ROWS_PER_LANE:
        cells = {}
        for w in (1, 2, 4):
            B, Lt = 4 * _PEAK["sms"] * w, 4096
            q, t = codes(B, 32 * R), codes(B, Lt)
            ms = queued_ms(lambda: sw_cuda.sw_score_cuda(q, t, no_n=True, rows_per_lane=R), 5)
            cells[w] = ms * 1e-3 * hz / (Lt + 31) / w
        steps = {}
        for S in (1, 8):
            q, t = codes(1, 32 * R * S), codes(1, 2048)
            ms = queued_ms(lambda: sw_cuda.sw_score_cuda(q, t, no_n=True, rows_per_lane=R), 5)
            steps[S] = ms * 1e-3 * hz
        lag = (steps[8] / steps[1] - 1) * (2048 + 31) / 7
        table[R] = (cells[1], cells[4], lag)
        print(f"  SW step clocks a warp, R={R} (ticket form): "
              + ", ".join(f"{w}/partition {c:.0f}" for w, c in cells.items())
              + f"; strip lag {lag:.0f} steps [{card}]", flush=True)
    for R in sw_cuda.BLOCK_ROWS_PER_LANE:
        clocks = {}
        for S in (4, 16):
            for Lt in (512, 2048):
                q, t = codes(1, 32 * R * S), codes(1, Lt)
                clocks[S, Lt] = queued_ms(lambda: sw_cuda.sw_score_cuda(
                    q, t, no_n=True, rows_per_lane=R), 5) * 1e-3 * hz
        column = {S: (clocks[S, 2048] - clocks[S, 512]) / 1536 for S in (4, 16)}
        lag = (clocks[4, 512] / column[4] - (512 + 31)) / 3
        table[R] = (column[4], column[16] / 4, lag)
        print(f"  SW column clocks, R={R} (block form): 4 strips {column[4]:.0f}, 16 strips "
              f"{column[16]:.0f} ({column[16] / 4:.0f} a warp); strip lag {lag:.0f} steps "
              f"[{card}]", flush=True)
    return table


class SWRecorder:
    """While open, records the inputs of every ``sw_score_cuda`` call (the
    main path's SW launches; the wrapper still counts its own launches)
    and the form each launched in; ``by_shape`` then replays each call in
    that form and in the ticket form (the form every launch took before
    the block form existed, at the R its plan picks), in turns, for their
    device time (queued CUDA events, ``timing.queued_ms``), summed by
    (B, Lq, Lt), after holding the two forms' outputs equal (and the
    plain version's, at each shape's first call)."""

    def __enter__(self):
        from breakmer_tpu_torch.ops import sw_cuda

        self.mod, self.orig, self.calls, self.forms = sw_cuda, sw_cuda.sw_score_cuda, [], []

        def record(q, t, *args, **kwargs):
            self.calls.append((q.clone(), t.clone(), args, kwargs))
            before = dict(sw_cuda.LAUNCHES_BY_FORM)
            out = self.orig(q, t, *args, **kwargs)
            self.forms.append(next(f for f, n in sw_cuda.LAUNCHES_BY_FORM.items()
                                   if n != before[f]))
            return out

        sw_cuda.sw_score_cuda = record
        return self

    def __exit__(self, *exc):
        self.mod.sw_score_cuda = self.orig

    def form_counts(self) -> dict:
        return {f: self.forms.count(f) for f in self.mod.FORMS}

    def by_shape(self, label, card):
        from breakmer_tpu_torch.ops.sw import sw_score
        from breakmer_tpu_torch.timing import queued_ms

        before = self.mod.LAUNCHES, dict(self.mod.LAUNCHES_BY_FORM)
        out = {}
        for n, ((q, t, args, kwargs), form) in enumerate(zip(self.calls, self.forms)):
            shape = (q.shape[0], q.shape[1], t.shape[1])
            row = out.get(shape)
            if row is None:
                row = out[shape] = dict(launches=0, forms={f: 0 for f in self.mod.FORMS},
                                        ms=0.0, ticket_ms=0.0, bound_ms=0.0)
                want = sw_score(q, t, *args[:1], **{k: v for k, v in kwargs.items()
                                                    if k == "params"})
                check(sw_max_err(want, self.orig(q, t, *args, **kwargs)) == 0,
                      f"{label}: SW replay != plain at {shape}")
            row["launches"] += 1
            row["forms"][form] += 1
            ticket = self.mod._rows_per_lane(*shape, self.mod._sms(q.device))
            runs = {"plan": lambda: self.orig(q, t, *args, **kwargs),
                    "ticket": lambda: self.orig(q, t, *args,
                                                **{**kwargs, "rows_per_lane": ticket})}
            check(sw_max_err(runs["plan"](), runs["ticket"]()) == 0,
                  f"{label}: SW forms differ at call {n} {shape}")
            for key in (("plan", "ticket") if n % 2 == 0 else ("ticket", "plan")):
                ms = queued_ms(runs[key], n=3)
                row["ms" if key == "plan" else "ticket_ms"] += ms
            row["bound_ms"] += sw_bound(*shape)[0]
        # replays are no launches of the main path
        self.mod.LAUNCHES = before[0]
        self.mod.LAUNCHES_BY_FORM.update(before[1])
        for (B, Lq, Lt), r in sorted(out.items()):
            print(f"  {label} SW launches {B}x{Lq}x{Lt}: {r['launches']} ("
                  + ", ".join(f"{f} {c}" for f, c in r["forms"].items() if c)
                  + f"), kernel {r['ms']:.4f} ms summed (ticket form {r['ticket_ms']:.4f}), "
                  f"bound {r['bound_ms']:.4f} ms, launches x (time - bound) "
                  f"{r['ms'] - r['bound_ms']:.4f} ms [{card}]", flush=True)
        total = {k: sum(r[k] for r in out.values()) for k in ("ms", "ticket_ms", "bound_ms")}
        print(f"  {label} SW replay: {len(self.calls)} launches over {len(out)} shapes ("
              + ", ".join(f"{f} {c}" for f, c in self.form_counts().items())
              + f"): {total['ms']:.4f} ms as planned, {total['ticket_ms']:.4f} ms in the "
              f"ticket form ({total['ms'] / total['ticket_ms']:.3f}x), bound "
              f"{total['bound_ms']:.4f} ms [{card}]", flush=True)
        return [dict(shape=list(k), **v) for k, v in sorted(out.items())]


# A contig window of the germline recheck; the k-mer kernels' other shapes
# are tools/kmer_time.py's SERIAL (a region of the serial path) and BATCH
# (phase 9's batch step)
KMER_CONTIG = 60
SENTINEL = 0xFFFFFFFF  # an invalid k-mer slot, as ops/kmer.py carries it
KMER_KERNELS = {  # name: the jitted JAX function (an XLA program, no Pallas kernel)
    "kmer_codes": "breakmer_tpu/ops/kmer.py:43-44",
    "revcomp_kmers": "breakmer_tpu/ops/kmer.py:102-103",
    "unique_counts_sorted": "breakmer_tpu/ops/kmer.py:121-122",
    "subtract_sorted": "breakmer_tpu/ops/kmer.py:162-163",
}
# a function that launches another's kernel: the counter its launches go to
KMER_COUNTER = {"both_strands": "revcomp_kmers"}


def kmer_kernel_inputs(rng, dev, G, sample, ref, normal):
    """The four kernels' inputs on the card for G regions (G = 0: one
    region, unbatched rows): errored reads tiled over a haplotype that
    carries 300 novel bases against the reference, a matched normal of
    its first half; each kernel's arguments as the engine passes them."""
    from breakmer_tpu_torch.ops import kmer

    g = max(G, 1)
    (R, L), (Rn, Ln) = sample, normal
    hap = rng.integers(0, 4, (g, ref + 300)).astype(np.int8)
    refs = np.concatenate([hap[:, :ref // 2], hap[:, ref // 2 + 300:]], axis=1)

    def tile(n, width, hi):
        starts = rng.integers(0, hi - width + 1, (g, n))
        codes = hap[np.arange(g)[:, None, None], starts[:, :, None] + np.arange(width)]
        err = rng.random(codes.shape) < 0.01
        codes[err] = rng.integers(0, 4, int(err.sum()))
        codes[rng.random(codes.shape) < 0.001] = 4
        return codes.reshape(g * n, width)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    reads, nreads = on(tile(R, L, ref + 300)), on(tile(Rn, Ln, ref // 2 + 150))
    lengths = on(np.full(g * R, L, np.int32))
    nlengths = on(np.full(g * Rn, Ln, np.int32))
    refs, ref_len = on(refs), on(np.full(g, ref, np.int32))
    rkm = kmer.kmer_codes_plain(refs, ref_len, 15)[0]
    table = torch.sort(torch.cat([rkm, kmer.revcomp_kmers_plain(rkm, 15)], -1), -1).values
    lead = (G,) if G else ()
    srt = torch.sort(kmer.kmer_codes_plain(reads, lengths, 15)[0].reshape(*lead, -1), -1).values
    values, counts, _ = kmer.unique_counts_sorted_plain(srt)
    ntable = torch.sort(kmer.kmer_codes_plain(nreads, nlengths, 15)[0].reshape(*lead, -1),
                        -1).values
    if not G:
        table = table[0]
    return {"kmer_codes": (reads, lengths, 15), "revcomp_kmers": (rkm, 15),
            "both_strands": (rkm, 15), "unique_counts_sorted": (srt,),
            "subtract_sorted": (values, counts, table, ntable)}


def kmer_bound(args, out):
    """(bound_ms, "bytes"): each input read once, each output written once."""
    nbytes = sum(x.numel() * x.element_size() for x in (*args, *out)
                 if isinstance(x, torch.Tensor))
    return bound(nbytes)


def kmer_library(name, args):
    """The one PyTorch call computing the same function (the port never
    calls it), or None: ``unique_consecutive`` with counts for the run
    lengths (compact layout, over the flattened rows), ``isin`` against
    the reference table for the membership half of the subtraction."""
    if name == "unique_counts_sorted":
        return lambda: torch.unique_consecutive(args[0].reshape(-1), return_counts=True)
    if name == "subtract_sorted":
        return lambda: torch.isin(args[0], args[2])
    return None


def kmer_kernel_row(name, args, label, card):
    """One k-mer function's kernel against its plain version on the card,
    exact, one launch; its device time (queued calls), a call's time
    (events), the plain version's, the bound and the library call's."""
    from breakmer_tpu_torch.ops import kmer, kmer_cuda
    from breakmer_tpu_torch.timing import cuda_ms, queued_ms

    kernel, plain = getattr(kmer, name), getattr(kmer, f"{name}_plain")
    counter = KMER_COUNTER.get(name, name)
    before = kmer_cuda.LAUNCHES[counter]
    got = kernel(*args)
    torch.cuda.synchronize()
    check(kmer_cuda.LAUNCHES[counter] == before + 1, f"{name}: not one launch of its kernel")
    got = got if isinstance(got, tuple) else (got,)
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    check(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(want, got)),
          f"{name} ({label}): kernel != plain")
    lib = kmer_library(name, args)
    r = dict(shape=[list(a.shape) for a in args if isinstance(a, torch.Tensor)],
             max_abs_err=0, ms=cuda_ms(lambda: kernel(*args)),
             device_ms=queued_ms(lambda: kernel(*args)),
             plain_ms=cuda_ms(lambda: plain(*args)),
             plain_device_ms=queued_ms(lambda: plain(*args)),
             library_ms=None if lib is None else cuda_ms(lib),
             library_device_ms=None if lib is None else queued_ms(lib),
             bound=kmer_bound(args, got))
    r["bound_share"] = r["bound"][0] / r["device_ms"]
    lib_txt = "none" if lib is None else (
        f"{r['library_ms']:.4f} ({r['library_device_ms']:.4f} device)")
    print(f"  {name} {label} {r['shape']}: kernel == plain; device "
          f"{r['device_ms']:.4f} ms (queued), a call {r['ms']:.4f} ms; plain "
          f"{r['plain_ms']:.4f} ({r['plain_device_ms']:.4f} device); bound "
          f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), {100 * r['bound_share']:.1f} % of "
          f"the device time; library {lib_txt} ms [{card}]", flush=True)
    return r


def kmer_kernel_rows(dev, card):
    """Each k-mer kernel against its plain version on the card, exact, at
    the serial path's and the batch step's shapes, as ``kmer_kernel_row``
    holds and times it: the four functions, the both-strand form of
    ``revcomp_kmers`` (the main path's form of that kernel: its row, with
    the function alone beside it) and, at the batch step's shape,
    ``unique_counts_sorted`` on random reads too (tools/kmer_time.py's);
    then the design edges (``kmer_edges``) and the CUDA kernels one
    sample_only_kmers call runs (``kmer_call_count``). Returns (kernel
    rows for the table, keyed by kernel name; the kernels a call)."""
    from breakmer_tpu_torch.ops import kmer
    from breakmer_tpu_torch.timing import queued_ms
    from breakmer_tpu_torch.tools import kmer_time

    rng = np.random.default_rng(9)
    forms = {"serial": kmer_kernel_inputs(rng, dev, **kmer_time.SERIAL),
             "batch": kmer_kernel_inputs(rng, dev, **kmer_time.BATCH)}
    rows = {}
    for form, inputs in forms.items():
        for name, args in inputs.items():
            r = kmer_kernel_row(name, args, form, card)
            if name == "kmer_codes" and form == "serial":  # a contig window too
                row = args[0][:1, :KMER_CONTIG].contiguous()
                one = torch.tensor([KMER_CONTIG], dtype=torch.int32, device=dev)
                check(all(torch.equal(a, b) for a, b in zip(
                    kmer.kmer_codes_plain(row, one, 15), kmer.kmer_codes(row, one, 15))),
                    "kmer_codes (contig window): kernel != plain")
                r["contig_device_ms"] = queued_ms(lambda: kmer.kmer_codes(row, one, 15))
            if form == "serial":
                rows[name] = r
            else:
                rows[name]["batch_step"] = {k: v for k, v in r.items() if k != "max_abs_err"}
    srt = kmer_time.inputs(rng, **kmer_time.BATCH)["unique_counts_sorted"]
    r = kmer_kernel_row("unique_counts_sorted", srt, "batch, random reads", card)
    rows["unique_counts_sorted"]["batch_step"]["random_reads"] = {
        k: r[k] for k in ("device_ms", "ms", "bound", "bound_share")}
    alone = rows.pop("revcomp_kmers")
    rows["revcomp_kmers"] = dict(rows.pop("both_strands"), form="both_strands", alone=alone)
    kmer_edges(dev, card)
    rows["region_kmers"] = region_kernel_row(dev, card)
    return rows, kmer_call_count(card)


def region_bound(args, kw, kept: int):
    """(bound_ms, by) of one region's call: its inputs read once (codes,
    lengths), its (value, count) pairs and count written once; and 3
    int32 operations a window of the three sets (a shift, an or and a
    mask of the rolling code)."""
    arrays = [a for a in (*args[:3], kw.get("normal_codes"), kw.get("normal_lengths"))
              if a is not None]
    nbytes = sum(np.asarray(a).nbytes for a in arrays) + 8 * kept + 8
    k = args[3]
    windows = sum(a.shape[0] * (a.shape[1] - k + 1)
                  for a in (args[0], kw.get("normal_codes")) if a is not None)
    windows += len(args[2]) - k + 1
    return bound(nbytes, int32_ops=3 * windows)


def region_kernel_row(dev, card):
    """The region kernel (csrc/region_kmers.cu, a serial region's whole
    sample_only_kmers in one launch of a thread-block cluster) against the
    plain chain on the card, exact: every region case (tools/kmer_time.py's,
    among them one read either side of the first design's limit and of the
    plan's) through the plan's route (one launch of the region kernel
    where it fits, the per-function kernels past the plan's limit), then
    the fused route forced at each cluster size the card runs that takes
    the case; at the serial shape, timed at the plan's cluster size and at
    one block (device ms of queued launches on staged inputs, events
    around one launch, the whole call's host ms with its two copies, the
    plain chain's) with the phase clocks at the plan's size."""
    from breakmer_tpu_torch.ops import kmer, kmer_cuda
    from breakmer_tpu_torch.timing import cuda_ms, queued_ms
    from breakmer_tpu_torch.tools import kmer_time

    def wall_ms(fn, reps=20):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    def same(want, got):
        return all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(want, got))

    sizes = kmer_cuda.cluster_sizes(dev)
    routes = {"fused": 0, "per_function": 0}
    held = {}  # case: the cluster sizes it was held at, forced
    for name in kmer_time.REGION_CASES:
        args, kw = kmer_time.region_case(name)
        want = kmer.sample_only_kmers_plain(*args, **kw, device=dev)
        plan, _ = kmer_time.plan_of(args, kw)
        before = dict(kmer_cuda.LAUNCHES)
        got = kmer.sample_only_kmers(*args, **kw, device=dev)
        moved = {n: kmer_cuda.LAUNCHES[n] - before[n] for n in before
                 if kmer_cuda.LAUNCHES[n] != before[n]}
        check(same(want, got), f"region_kmers ({name}): the plan's route != plain")
        check((moved == {"region_kmers": 1}) == (plan.route == "fused"),
              f"region_kmers ({name}): launches {moved} on the {plan.route} route")
        routes[plan.route] += 1
        held[name] = []
        for C in sizes:
            if kmer_time.plan_of(args, kw, C)[0].route == "fused":
                v, c = kmer_cuda.region_kmers(*args, **kw, device=dev, cluster=C)
                check(same(want, kmer._by_count(v, c, kw["min_count"])),
                      f"region_kmers ({name}), forced to {C} CTAs: kernel != plain")
                held[name].append(C)
    for name in ("old_limit_fits", "old_limit_over", "past_old_limit", "deep_250", "serial"):
        check(len(held[name]) > 0 and held[name][-1] > 1,
              f"region_kmers ({name}): held at no cluster: {held[name]}")
    check(held["boundary_over"] == [], "region_kmers: a size took the plan's boundary_over")
    args, kw = kmer_time.region_case("serial")
    plan, C = kmer_time.plan_of(args, kw)
    check(C > 1, f"region_kmers: the serial shape's plan is a cluster of {C}")
    launch, _ = kmer_time.region_launcher(args, kw)
    one_block, _ = kmer_time.region_launcher(args, kw, 1)
    want = kmer.sample_only_kmers_plain(*args, **kw, device=dev)
    median = kmer_time.region_inputs(np.random.default_rng(0), R=47, L=101, normal=(40, 101))
    r = dict(shape=[list(np.shape(args[0])), len(args[2]), list(np.shape(kw["normal_codes"]))],
             max_abs_err=0, cluster=C, cluster_sizes=list(sizes), ms=cuda_ms(launch),
             device_ms=queued_ms(launch), one_block_device_ms=queued_ms(one_block),
             call_ms=kmer_time.call_us(lambda: kmer.sample_only_kmers(*args, **kw, device=dev))
             / 1e3,
             median_region_call_ms=kmer_time.call_us(
                 lambda: kmer.sample_only_kmers(*median[0], **median[1], device=dev)) / 1e3,
             plain_ms=wall_ms(lambda: kmer.sample_only_kmers_plain(*args, **kw, device=dev), 5),
             library_ms=None, library_device_ms=None, bound=region_bound(args, kw, len(want[0])),
             region_cases=routes, held_at=held, smem_bytes=plan.smem_bytes,
             phase_clocks=kmer_time.phase_clocks("serial"))
    r["plain_device_ms"] = None
    r["bound_share"] = r["bound"][0] / r["device_ms"]
    print(f"  region_kmers serial {r['shape']}: kernel == plain ({len(want[0])} kept) at the "
          f"plan's cluster of {C} CTAs ({plan.smem_bytes} bytes of shared memory a CTA); "
          f"device {r['device_ms']:.4f} ms (queued; one block {r['one_block_device_ms']:.4f}), "
          f"one launch {r['ms']:.4f} ms (events), a call {r['call_ms']:.4f} ms (host clock, its "
          f"two copies and its wait; the panel's median region {r['median_region_call_ms']:.4f}"
          f"), plain chain {r['plain_ms']:.4f} ms; bound "
          f"{r['bound'][0]:.5f} ms ({r['bound'][1]}), {100 * r['bound_share']:.2f} % of the "
          f"device time; library none [{card}]", flush=True)
    print(f"  region_kmers phase clocks at {C} CTAs (cycles, the most any CTA took): "
          f"{r['phase_clocks']['cycles']} [{card}]", flush=True)
    print(f"  region_kmers: the card runs cluster sizes {list(sizes)}; the "
          f"{len(kmer_time.REGION_CASES)} region cases exact on the plan's routes {routes}, and "
          f"forced at every size that takes them: {held} [{card}]", flush=True)
    return r


def kmer_call_count(card):
    """The CUDA kernels of one serial region's sample_only_kmers call, read
    by tools/kmer_time.call_profile in a fresh process (``--call``) and in
    this one: the profiler's activities and, per hand kernel, those under
    its symbol beside its wrapper's launches in that call. Fails unless
    the fresh process's profiler saw every hand-kernel launch and no
    other. Returns the fresh reading."""
    import subprocess

    from breakmer_tpu_torch.tools import kmer_time

    proc = subprocess.run([sys.executable, "-m", "breakmer_tpu_torch.tools.kmer_time",
                           "--call", "--reps", "5"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    check(proc.returncode == 0, f"kmer_time --call failed: {proc.stderr[-2000:]}")
    reading = json.loads(proc.stdout.strip().splitlines()[-1])
    fresh = reading["sample_only_kmers"]
    per_function = reading["sample_only_kmers per_function"]
    here = kmer_time.call_profile(np.random.default_rng(0), reps=5)
    for label, call in (("a fresh process", fresh), ("this process", here),
                        ("a fresh process, the per-function route forced", per_function)):
        seen, launched = call["hand_kernels_seen"], call["hand_kernels_launched"]
        print(f"  sample_only_kmers {kmer_time.SERIAL}, profiled in {label}: "
              f"{call['kernels']} CUDA kernels and {call['copies']} copies a call, "
              f"{call['device_ms']:.4f} ms of device time, {call['wall_ms']:.4f} ms a call; "
              f"hand kernels seen {seen}, launched {launched} [{card}]", flush=True)
    for label, call in (("", fresh), (" (per-function route)", per_function)):
        check(call["hand_kernels_seen"] == call["hand_kernels_launched"],
              f"sample_only_kmers{label}: the profiler's hand kernels in a fresh process "
              f"{call['hand_kernels_seen']} != their launches {call['hand_kernels_launched']}")
    check(fresh["hand_kernels_launched"]["region_kmers"] == 1 and fresh["kernels"] == 1,
          f"sample_only_kmers at the serial shape: {fresh['kernels']} kernels, not one launch "
          "of the region kernel")
    keys = ("kernels", "copies", "device_ms", "wall_ms", "hand_kernels_seen",
            "hand_kernels_launched")
    return {**{k: fresh[k] for k in keys}, "this_process": {k: here[k] for k in keys},
            "per_function_route": {k: per_function[k] for k in keys}}


def kmer_edges(dev, card):
    """The k-mer kernels that tile their rows, exact against their plain
    versions at those designs' edges, one launch a call: for kmer_codes
    spans that cross rows and end ragged, k = 1, L < 16, a row of 5,000
    bases, poly-A rows, negative bytes (at the batch step's size too),
    codes off a 16-byte line, k = -2, -1 and 0 (windows of no base, W > L,
    rows of 0 bases, at both of its spans); for subtract_sorted queries in any order, a
    table range wider than one staged chunk, tiles of SENTINEL alone, an
    odd row width, rows off a 16-byte line, values past 32 bits; for
    unique_counts_sorted runs that cross one tile and many, poly-A rows,
    all-SENTINEL rows, n = 1, a ragged last tile, the SENTINEL boundary
    inside a tile, an odd n, rows off a 16-byte line, runs of every
    length, at both of the launch's tile sizes; for both_strands (the
    revcomp_kmers kernel) an odd width, rows off a 16-byte line, one code,
    values of any int64, every k from -2 to 15, at both of its tile
    sizes."""
    from breakmer_tpu_torch.ops import kmer, kmer_cuda
    from breakmer_tpu_torch.timing import queued_ms

    rng = np.random.default_rng(10)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def reads(R, L, n_rate=0.03, neg_rate=0.0):
        codes = rng.integers(0, 4, (R, L)).astype(np.int8)
        codes[rng.random((R, L)) < n_rate] = 4
        neg = rng.random((R, L)) < neg_rate
        codes[neg] = rng.integers(-128, 0, int(neg.sum()))
        return on(codes), on(rng.integers(L // 2, L + 3, R).astype(np.int32))

    def sorted_rows(G, N, hi, sent_from):
        x = np.sort(rng.integers(0, hi, (G, N)), axis=1)
        x[:, sent_from:] = SENTINEL
        return on(x)

    def once(name, fn, plain, *args):
        counter = KMER_COUNTER.get(name, name)
        before = kmer_cuda.LAUNCHES[counter]
        got = fn(*args)
        torch.cuda.synchronize()
        check(kmer_cuda.LAUNCHES[counter] == before + 1, f"{name} (edges): not one launch")
        got, want = ((x if isinstance(x, tuple) else (x,)) for x in (got, plain(*args)))
        check(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(want, got)),
              f"{name} (edges {[tuple(a.shape) for a in args if hasattr(a, 'shape')]}): "
              "kernel != plain")

    codes_cases = [(*reads(37, 23), 5), (*reads(3, 700), 15), (*reads(9, 30), 1),
                   (*reads(300, 15), 15), (*reads(250, 9), 4), (*reads(1, 5000, 0.002), 15),
                   (on(np.zeros((200, 100), np.int8)), on(np.full(200, 100, np.int32)), 15),
                   (*reads(512, 128, 0.02, 0.03), 15), (*reads(32 * 512, 128, 0.01, 0.0005), 15)]
    flat = on(np.concatenate([np.zeros(3), rng.integers(0, 4, 200 * 100)]).astype(np.int8))
    codes_cases.append((flat[3:].view(200, 100), on(np.full(200, 100, np.int32)), 15))
    codes_cases += [(*reads(37, 23), -2), (*reads(200, 100, 0.02, 0.01), -1),
                    (*reads(50, 0), 0), (*reads(9, 3), -1), (*reads(32 * 512, 128), 0)]
    for codes, lengths, k in codes_cases:
        once("kmer_codes", kmer.kmer_codes, kmer.kmer_codes_plain, codes, lengths, k)
    row, one = reads(1, 5000, 0.002)
    row_ms = queued_ms(lambda: kmer.kmer_codes(row, one, 15))

    v, c = kmer.unique_counts_sorted_plain(sorted_rows(4, 9000, 6000, 8000))[:2]
    pv, pc = kmer.unique_counts_sorted_plain(torch.zeros((3, 5000), dtype=torch.int64,
                                                         device=dev))[:2]
    ov, oc = kmer.unique_counts_sorted_plain(sorted_rows(1, 4097, 3000, 4097))[:2]
    subtract_cases = [
        (v[:, torch.from_numpy(rng.permutation(9000)).to(dev)].contiguous(), c,
         sorted_rows(4, 3000, 6000, 2700), sorted_rows(4, 5000, 6000, 4500)),
        (v, c, on(np.sort(rng.integers(0, 6000, (4, 12000)), axis=1)),
         sorted_rows(4, 30000, 6000, 27000)),
        (*kmer.unique_counts_sorted_plain(sorted_rows(2, 20000, 900, 2500))[:2],
         sorted_rows(2, 500, 900, 450), None),
        (pv, pc, on(np.array([[0, 5, SENTINEL]] * 3)), on(np.array([[1, 2]] * 3))),
        (ov, oc, sorted_rows(1, 777, 3000, 700), sorted_rows(1, 311, 3000, 280)),
        (v[0, 1:], c[0, 1:], sorted_rows(1, 800, 6000, 720)[0], sorted_rows(1, 900, 6000, 810)[0]),
    ]
    wide = on(np.sort(rng.integers(-(1 << 40), 1 << 40, (150, 5000)), axis=1))
    wv, wc = kmer.unique_counts_sorted_plain(wide)[:2]
    subtract_cases.append((wv, wc, wide[:, ::3].contiguous(), wide[:, 1::7].contiguous()))
    for args in subtract_cases:
        once("subtract_sorted", kmer.subtract_sorted, kmer.subtract_sorted_plain, *args)

    def runs_of_every_length(n):
        return np.repeat(np.arange(300), np.arange(1, 301))[:n][None, :]

    off_line = on(np.concatenate([[0], np.sort(rng.integers(0, 60, (2, 1000)), 1).ravel()]))
    count_cases = [
        on(np.zeros((1, 200 * 86), np.int64)),    # one run through every tile (2 slots a thread)
        on(np.zeros((140, 5000), np.int64)),      # and at 8 slots a thread (>= 132 blocks)
        sorted_rows(1, 20000, 5, 20000),          # runs across many tiles
        sorted_rows(140, 2100, 3, 2100),
        sorted_rows(32, 512 * 114, 2000, 55000),  # runs across one tile, the batch shape
        on(np.full((3, 77), SENTINEL, np.int64)),
        on(np.array([[42]])), on(np.array([[SENTINEL]])), on(np.array([[4], [SENTINEL], [9]])),
        sorted_rows(3, 1550, 40, 1500),           # a ragged last tile
        sorted_rows(2, 1024, 20, 300),            # SENTINEL from inside a tile
        sorted_rows(5, 1333, 50, 1300),           # an odd n: slot by slot
        off_line[1:].view(2, 1000),               # rows off the 16-byte line: slot by slot
        on(runs_of_every_length(20000)), on(np.repeat(runs_of_every_length(4000), 140, 0)),
    ]
    for x in count_cases:
        once("unique_counts_sorted", kmer.unique_counts_sorted, kmer.unique_counts_sorted_plain, x)
    flat = on(np.concatenate([[0], rng.integers(0, 1 << 30, 2 * 600)]))
    strand_cases = [(on(rng.integers(0, 1 << 30, (1, 1786))), 15),
                    (on(rng.integers(0, 1 << 30, (32, 4082))), 15),
                    (on(rng.integers(0, 1 << 30, (3, 1001))), 15),  # odd: code by code
                    (flat[1:].view(2, 600), 5),                     # off the 16-byte line
                    (on(np.array([SENTINEL])), 3),
                    (on(rng.integers(-(1 << 62), 1 << 62, (200, 3000))), 11),  # 8 codes a thread
                    (on(rng.integers(-(1 << 62), 1 << 62, (200, 3000))), 0)]
    wide = on(np.concatenate([rng.integers(-(1 << 62), 1 << 62, 500), [SENTINEL] * 10]))
    strand_cases += [(wide, k) for k in range(-2, 16)]
    for x, k in strand_cases:
        once("both_strands", kmer.both_strands, kmer.both_strands_plain, x, k)
        once("revcomp_kmers", kmer.revcomp_kmers, kmer.revcomp_kmers_plain, x, k)
    print(f"  kmer_codes, subtract_sorted, unique_counts_sorted, both_strands and revcomp_kmers "
          f"exact at their span and tile edges ({len(codes_cases)}, {len(subtract_cases)}, "
          f"{len(count_cases)}, {len(strand_cases)} and {len(strand_cases)} cases, one launch a "
          f"call); kmer_codes on a row of 5,000 bases {row_ms:.4f} ms (queued) [{card}]",
          flush=True)


def phase_kmer(dev, card):
    """The k-mer engine on the card against the CPU (2,000 x 150 bp reads,
    a 3 kb region, a matched normal), then each k-mer kernel as
    ``kmer_kernel_rows`` holds and times it."""
    from breakmer_tpu_torch.ops.kmer import sample_only_kmers

    rng = np.random.default_rng(7)
    region = rng.integers(0, 4, 3000).astype(np.int8)
    novel = rng.integers(0, 4, 400).astype(np.int8)

    def reads(n, src):
        """n errored 150 bp reads of src (1% substitutions, 0.1% N)."""
        starts = rng.integers(0, len(src) - 150, n)
        codes = np.stack([src[s:s + 150] for s in starts])
        err = rng.random(codes.shape) < 0.01
        codes[err] = rng.integers(0, 4, int(err.sum()))
        codes[rng.random(codes.shape) < 0.001] = 4
        return codes.astype(np.int8), np.full(n, 150, dtype=np.int32)

    # the sample carries a 400 bp insertion; the normal carries half of it
    s_codes, s_len = reads(2000, np.concatenate([region[:1500], novel, region[1500:]]))
    n_codes, n_len = reads(2000, np.concatenate([region[:1500], novel[:200], region[1500:]]))
    args = (s_codes, s_len, region, 15)
    kw = dict(normal_codes=n_codes, normal_lengths=n_len)
    want = sample_only_kmers(*args, **kw, device="cpu")
    got = sample_only_kmers(*args, **kw, device=dev)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        check(a.dtype == b.dtype and np.array_equal(a, b), "k-mer engine: CUDA != CPU")
    check(len(got[0]) > 0, "k-mer engine: no sample-only k-mers")
    for a, b in zip(want, sample_only_kmers(*args, **kw, device=dev, route="per_function")):
        check(a.dtype == b.dtype and np.array_equal(a, b),
              "k-mer engine, the per-function route: CUDA != CPU")
    from breakmer_tpu_torch.tools.kmer_time import plan_of

    plan, C = plan_of(args, kw)
    print(f"  kmer: the plan's route {plan.route} at {C} CTAs; the per-function route forced "
          "== CPU too", flush=True)
    t0 = time.perf_counter()
    sample_only_kmers(*args, **kw, device=dev)
    ms = (time.perf_counter() - t0) * 1e3
    print(f"  kmer: CUDA == CPU, {len(got[0])} sample-only k-mers; "
          f"{ms:.2f} ms a call on the card (host clock) [{card}]", flush=True)
    return kmer_kernel_rows(dev, card)


class KmerCalls:
    """Counts the serial path's sample_only_kmers calls (those with a
    matched normal apart) and their routes while it is entered, keeps each
    call's arguments (``record``), and sets every k-mer kernel's launch
    count to 0 on entry; ``launches`` and ``routes`` hold the counts on
    exit."""

    def __init__(self, record: bool = False):
        self.record = record

    def __enter__(self):
        from breakmer_tpu_torch import pipeline
        from breakmer_tpu_torch.ops import kmer, kmer_cuda

        self.pipeline, self.kmer, self.kmer_cuda = pipeline, kmer, kmer_cuda
        self.orig = pipeline.sample_only_kmers
        self.calls = self.with_normal = 0
        self.shapes = []  # (sample reads, read length, reference length) a call
        self.args = []    # (args, kwargs) a call, with record

        def counted(*args, normal_codes=None, **kw):
            self.calls += 1
            self.with_normal += normal_codes is not None
            self.shapes.append((*args[0].shape, len(args[2])))
            if self.record:
                self.args.append((args, dict(kw, normal_codes=normal_codes)))
            return self.orig(*args, normal_codes=normal_codes, **kw)

        pipeline.sample_only_kmers = counted
        for name in kmer_cuda.LAUNCHES:
            kmer_cuda.LAUNCHES[name] = 0
        self.routes_before = dict(kmer.ROUTES)
        return self

    def __exit__(self, *exc):
        self.launches = dict(self.kmer_cuda.LAUNCHES)
        self.routes = {r: n - self.routes_before[r] for r, n in self.kmer.ROUTES.items()}
        self.pipeline.sample_only_kmers = self.orig

    def check(self, label: str, serial: bool) -> dict:
        """The kernels of the path launched. Serial: one region kernel
        launch a fused call, the per-function kernels on the per-function
        route's calls alone (kmer_codes at least twice each, and for the
        germline recheck), every call counted under one route. Batched:
        the four per-function kernels, no region kernel."""
        n = self.launches
        if serial:
            fused, per = self.routes["fused"], self.routes["per_function"]
            check(fused + per == self.calls,
                  f"{label}: routes {self.routes} for {self.calls} sample_only_kmers calls")
            check(n["region_kmers"] == fused,
                  f"{label}: {n['region_kmers']} region kernel launches for {fused} fused calls")
            check(n["kmer_codes"] >= 2 * per,
                  f"{label}: {n['kmer_codes']} kmer_codes launches for {per} per-function calls")
            for name in ("revcomp_kmers", "unique_counts_sorted", "subtract_sorted"):
                check((n[name] > 0) == (per > 0),
                      f"{label}: {name} launched {n[name]} times for {per} per-function calls")
        else:
            check(n["region_kmers"] == 0, f"{label}: the batched path launched the region kernel")
            for name in self.kmer_cuda.KERNELS:
                check(n[name] > 0, f"{label}: the {name} kernel launched no time")
        med = np.median(np.array(self.shapes), axis=0).tolist() if self.shapes else None
        print(f"  {label} k-mer kernel launches {n} ({self.calls} regions reached the k-mer "
              f"stage, {self.with_normal} with a normal; routes {self.routes}; median sample "
              f"reads, read length, reference length {med})", flush=True)
        return n


def replay_regions(calls, card, label):
    """Every recorded serial call (a region's arguments) through the region
    kernel, the fused route forced where its plan fuses, exact against
    the plain chain on the card; the plan's routes and cluster sizes
    counted; then the fused regions' launches alone, on inputs staged
    beforehand, back to back (tools/kmer_time.back_to_back_ms: queued
    behind a sleep, between two CUDA events; their summed device time)."""
    from breakmer_tpu_torch.ops import kmer

    from breakmer_tpu_torch.tools import kmer_time

    dev = card0()
    routes = {"fused": 0, "per_function": 0}
    clusters = {}  # the plan's cluster size: its fused regions
    staged = []
    for args, kw in calls:
        normal = kw.get("normal_codes")
        plan, _ = kmer_time.plan_of(args, kw)
        routes[plan.route] += 1
        if plan.route == "fused":
            kw = {k: v for k, v in kw.items() if k != "device"}
            want = kmer.sample_only_kmers_plain(*args, **kw, device=dev)
            got = kmer.sample_only_kmers(*args, **kw, device=dev, route="fused")
            check(all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(want, got)),
                  f"{label}: region kernel != plain on a region of {np.shape(args[0])}")
            launch, _ = kmer_time.region_launcher(args, kw)
            staged.append(launch)
            clusters[plan.cluster] = clusters.get(plan.cluster, 0) + 1
    ms = kmer_time.back_to_back_ms(staged)
    print(f"  {label}: the region kernel == plain on each of the {routes['fused']} fused "
          f"regions; routes by the plan {routes}, cluster sizes {clusters}; their "
          f"{len(staged)} launches back to back {ms:.4f} ms (events) [{card}]", flush=True)
    return dict(routes, launches_ms=ms, clusters={str(c): n for c, n in sorted(clusters.items())})


def run_panel(cfg_kwargs, out: Path, device: str):
    """Drive the port as ``python -m breakmer_tpu_torch.cli run`` does."""
    from breakmer_tpu_torch.config import Config
    from breakmer_tpu_torch.runner import Runner

    cfg = Config(**{**cfg_kwargs, "analysis_dir": str(out), "device": device,
                    "log_level": "WARNING"})
    runner = Runner(cfg)
    t0 = time.perf_counter()
    runner.setup()
    t1 = time.perf_counter()
    events = runner.run()
    if device != "cpu":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    metrics = json.loads((out / "metrics.json").read_text())
    check(not metrics["errors"], f"{device} run: region errors {metrics['errors']}")
    return events, metrics, t1 - t0, t2 - t1, runner


def checker_results(checks, events):
    res = {}
    for gene, (kind, chk) in checks.items():
        evs = [e for e in events if e.genes.split(",")[0] == gene]
        res[gene] = (kind, chk(evs))
    return res


def phase_slice_exact(card):
    from breakmer_tpu_torch.testing.scenarios import build_scenario

    for seed, kinds in CI_KINDS.items():
        work = WORK / f"seed{seed}"
        work.mkdir(parents=True)
        cfg_kwargs, checks = build_scenario(seed, work, n_genes=4, kinds=kinds,
                                            with_normal_germline=True, multi_sv_gene=True)
        cfg_kwargs["batch_regions"] = False
        events, _, _, run_s, _ = run_panel(cfg_kwargs, work / "cuda", "cuda")
        fails = [f"{g} ({k}): {f}" for g, (k, fs) in checker_results(checks, events).items()
                 for f in fs]
        check(not fails, f"seed {seed} on CUDA: " + "; ".join(fails))
        print(f"  slice seed {seed}: {len(checks)} checkers pass on CUDA "
              f"({len(events)} calls, {run_s:.2f} s) [{card}]", flush=True)
    torch.cuda.synchronize()


def build_panel100():
    """The 100-gene errored panel with a matched normal and a two-SV gene
    (scenario seed 5, deeper coverage): (cfg_kwargs, checks, work)."""
    from breakmer_tpu_torch.testing.scenarios import build_scenario

    work = WORK / "panel100"
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    cfg_kwargs, checks = build_scenario(5, work, n_genes=100, read_step=2,
                                        with_normal_germline=True, multi_sv_gene=True)
    print(f"  panel built in {time.perf_counter() - t0:.1f} s", flush=True)
    return cfg_kwargs, checks, work


def phase_slice_scale(card, panel):
    from breakmer_tpu_torch.utils.meter import METER
    from breakmer_tpu_torch.ops import sw_cuda

    cfg_kwargs, checks, work = panel
    cfg_kwargs = {**cfg_kwargs, "batch_regions": False}
    with KmerCalls(record=True) as kmer_calls:  # every k-mer kernel's count is 0 here
        sw_cuda.LAUNCHES = 0  # main path starts here
        sw_cuda.LAUNCHES_BY_FORM.update(ticket=0, block=0)
        events, metrics, setup_s, run_s, _ = run_panel(cfg_kwargs, work / "cuda", "cuda")
        launches = sw_cuda.LAUNCHES
        by_form = dict(sw_cuda.LAUNCHES_BY_FORM)
    kmer_launches = kmer_calls.check("panel100 serial", serial=True)
    sw_batches = METER.sw_launches
    check(kmer_launches["region_kmers"] > 0,
          f"panel100 serial: the region kernel launched no time: {kmer_launches}")
    check(launches > 0, "main path launched the SW kernel no time")
    check(launches == sw_batches,
          f"SW kernel launches {launches} != sw_score_batch calls {sw_batches}")
    check(sum(by_form.values()) == launches, f"SW launches by form {by_form} != {launches}")
    check(by_form["block"] > 0, "no serial SW launch took the block form")
    _, _, _, cpu_s, _ = run_panel(cfg_kwargs, work / "cpu", "cpu")
    for name in OUTPUTS:
        a = (work / "cuda" / "output" / name).read_bytes()
        b = (work / "cpu" / "output" / name).read_bytes()
        check(a == b, f"100-gene panel {name}: CUDA != CPU")
    n_regions = metrics["targets"]
    n_reads = sum(r["records"] for r in metrics["regions"].values())
    recall = {}
    for gene, (kind, fs) in checker_results(checks, events).items():
        hit, total = recall.get(kind, (0, 0))
        recall[kind] = (hit + (not fs), total + 1)
    sw = metrics["sw"]
    print(f"  panel100 CUDA: {n_regions} regions, {n_reads} reads, {len(events)} calls "
          f"in {run_s:.3f} s (setup {setup_s:.2f} s): {n_regions / run_s:.2f} regions/s, "
          f"{n_reads / run_s:.1f} reads/s; SW {sw['launches']} batches, "
          f"{sw['cells']} cells, {sw['wall_s']} s, {sw['gcups_wall']} GCUPS (METER) [{card}]")
    print(f"  panel100 CPU leg: {cpu_s:.3f} s, {n_regions / cpu_s:.2f} regions/s; "
          "svs.out and VCF byte-identical to CUDA")
    print("  recall per kind: " + ", ".join(
        f"{k}: {h}/{n}" for k, (h, n) in sorted(recall.items(), key=str)), flush=True)
    stages = {k: round(v, 3) for k, v in metrics["stage_s"].items()}
    print(f"  panel100 CUDA stage seconds: {stages}", flush=True)
    with SWRecorder() as rec:  # an untimed run for the launches by shape
        run_panel(cfg_kwargs, work / "cuda_recorded", "cuda")
    check(len(rec.calls) == launches and rec.form_counts() == by_form,
          f"the recorded serial run launched SW differently: {rec.form_counts()}, {by_form}")
    for (q, t, _, _), form in zip(rec.calls, rec.forms):  # the planned forms
        shape = (q.shape[0], q.shape[1], t.shape[1])
        check(form == sw_cuda.launch_plan(*shape, sms=sw_cuda._sms(q.device)).form,
              f"serial SW launch {shape} counted under {form}")
        check(shape not in {(1, 256, 512), (1, 256, 1024)} or form == "block",
              f"serial SW launch {shape} took the {form} form")
    print(f"  panel100 serial SW launches by form: {by_form} [{card}]", flush=True)
    by_shape = rec.by_shape("panel100 serial", card)
    torch.cuda.synchronize()
    routes = {"panel100": replay_regions(kmer_calls.args, card, "panel100 serial regions"),
              "bench_panel20": bench_panel_routes(card), **deep_tier_routes(card)}
    return launches, by_shape, kmer_launches, routes


def deep_tier_routes(card):
    """tools/bench_panel_scaling's deep tiers (read step 2 with 100-base
    reads, read step 1 with 250-base reads) at 100 genes on the serial
    path on the card: each region's route, counted, and the region kernel
    exact against the plain chain on each fused region; fails if a region
    that the plan fuses took another route."""
    from breakmer_tpu_torch import bench_panel
    from breakmer_tpu_torch.runner import Runner
    from breakmer_tpu_torch.tools.bench_panel_scaling import DEEP_TIERS

    out = {}
    for step, read_len in DEEP_TIERS:
        label = f"deep tier (read step {step}, {read_len}-base reads), 100 genes serial"
        work = WORK / f"deep_{step}_{read_len}"
        work.mkdir(parents=True)
        cfg = bench_panel.build_panel(work, 100, step, read_len=read_len, device="cuda")
        runner = Runner(type(cfg)(**{**cfg.__dict__, "batch_regions": False}))
        runner.setup()
        with KmerCalls(record=True) as calls:
            runner.run()
        torch.cuda.synchronize()
        check(not any(r.error for r in runner.results), f"{label}: region errors")
        replayed = replay_regions(calls.args, card, label)
        check(calls.routes == {r: replayed[r] for r in calls.routes},
              f"{label}: routes {calls.routes} != the plan's {replayed}")
        largest = max((tuple(np.shape(a[0])) for a, _ in calls.args), default=None)
        print(f"  {label}: {len(calls.args)} k-mer calls, routes {calls.routes}, the largest "
              f"sample {largest} [{card}]", flush=True)
        out[f"deep_{step}_{read_len}"] = dict(replayed, largest_sample=largest)
    return out


def bench_panel_routes(card):
    """bench_panel's 20-gene panel (its defaults: read step 6) on the
    serial path on the card: each region's route, counted, and the
    region kernel exact against the plain chain on each fused region."""
    from breakmer_tpu_torch import bench_panel
    from breakmer_tpu_torch.runner import Runner

    work = WORK / "bench_panel20_serial"
    work.mkdir(parents=True)
    cfg = bench_panel.build_panel(work, 20, 6, device="cuda")
    runner = Runner(type(cfg)(**{**cfg.__dict__, "batch_regions": False}))
    runner.setup()
    with KmerCalls(record=True) as calls:
        runner.run()
    torch.cuda.synchronize()
    check(not any(r.error for r in runner.results), "bench_panel 20 genes serial: region errors")
    calls.check("bench_panel 20 genes serial", serial=True)
    return replay_regions(calls.args, card, "bench_panel 20 genes serial regions")


def phase_batched_panel(card, panel, serial_sw_batches):
    """The batched path on the 100-gene panel: nprocs 1 cold, nprocs 1
    warm (timed), nprocs 4; each byte-identical to phase 6's serial CUDA
    output, every k-mer kernel launched. Returns the warm run's SW kernel
    launches, its SW launches by shape, its regions/s and its k-mer kernel
    launches."""
    from breakmer_tpu_torch.utils.meter import METER
    from breakmer_tpu_torch.ops import sw_cuda

    cfg_kwargs, _, work = panel
    serial = {name: (work / "cuda" / "output" / name).read_bytes() for name in OUTPUTS}
    warm_launches, warm_rate, kmer_launches, warm_by_form = 0, 0.0, {}, {}
    for label, nprocs in (("cold", 1), ("warm", 1), ("nprocs4", 4)):
        kw = {**cfg_kwargs, "batch_regions": True, "nprocs": nprocs}
        out = work / f"batched_{label}"
        with KmerCalls() as kmer_calls:
            sw_cuda.LAUNCHES = 0  # this run of the batched path starts here
            sw_cuda.LAUNCHES_BY_FORM.update(ticket=0, block=0)
            events, metrics, setup_s, run_s, runner = run_panel(kw, out, "cuda")
            launches = sw_cuda.LAUNCHES
            by_form = dict(sw_cuda.LAUNCHES_BY_FORM)
        kmer_calls.check(f"batched {label}", serial=False)
        sw_batches = METER.sw_launches
        check(launches > 0, f"batched {label}: the SW kernel launched no time")
        check(launches == sw_batches,
              f"batched {label}: SW kernel launches {launches} != SW batches {sw_batches}")
        for name in OUTPUTS:
            check((out / "output" / name).read_bytes() == serial[name],
                  f"batched {label} {name} != the serial CUDA output")
        kb = runner.kmer_pipeline
        n_regions = metrics["targets"]
        n_reads = sum(r["records"] for r in metrics["regions"].values())
        stages = {k: round(metrics["stage_s"].get(k, 0.0), 4)
                  for k in ("kmer_device", "extract_clean", "assemble", "realign", "classify")}
        print(f"  batched panel100 {label} (nprocs {nprocs}): {len(events)} calls in "
              f"{run_s:.4f} s (setup {setup_s:.2f} s): {n_regions / run_s:.2f} regions/s, "
              f"{n_reads / run_s:.1f} reads/s; stage s {stages}; {kb.dispatched} packed "
              f"k-mer launches, {kb.refetched} overflow refetches; SW {sw_batches} batches "
              f"(serial run: {serial_sw_batches}; by form {by_form}), "
              f"{metrics['sw']['cells']} cells; "
              f"svs.out and VCF == serial [{card}]", flush=True)
        if label == "warm":
            warm_launches, warm_rate, warm_by_form = launches, n_regions / run_s, by_form
            kmer_launches = kmer_calls.launches
    kw = {**cfg_kwargs, "batch_regions": True, "nprocs": 1}
    with SWRecorder() as rec:  # an untimed warm run for the launches by shape
        run_panel(kw, work / "batched_recorded", "cuda")
    check(len(rec.calls) == warm_launches and rec.form_counts() == warm_by_form,
          "the recorded batched run launched SW differently")
    by_shape = rec.by_shape("batched panel100 warm", card)
    torch.cuda.synchronize()
    return warm_launches, by_shape, warm_rate, kmer_launches


def phase_kmer_batch_step(dev, card):
    """The full and packed k-mer batch steps, card against CPU, exact; then
    each timed with its fetch (CUDA events, median of 5)."""
    from breakmer_tpu_torch.parallel import kmer_batch as kb
    from breakmer_tpu_torch.timing import cuda_ms

    # 256 novel bases a region: the kept k-mers fit the packed buffer
    G, R, L, LREF, RN = 32, 512, 128, 4096, 256
    tiled = tiled_region_inputs(G, R, L, LREF, 0, 1, 1, RN=RN, NOVEL=256)
    host = tuple(torch.from_numpy(a) for a in tiled[:4] + tiled[6:])
    args = tuple(a.to(dev) for a in host)
    cap = G * kb._PACK_SLOTS_PER_REGION
    forms = {"full": (kb._kmer_body(15, 2), kb._fetch_full),
             "packed": (kb._kmer_step_packed(15, 2, cap), lambda o: kb._fetch_packed([o]))}
    step_ms = cuda_ms(lambda: forms["full"][0](*args))
    print(f"  kmer batch step G={G} R={R} L={L} LREF={LREF} normal {RN}x{L}: "
          f"step alone {step_ms:.4f} ms [{card}]", flush=True)
    for name, (step, fetch) in forms.items():
        want = step(*host)
        got = step(*args)
        torch.cuda.synchronize()
        for a, b in zip(want, got):
            check(a.dtype == b.dtype and torch.equal(a, b.cpu()),
                  f"kmer batch step ({name}): CUDA != CPU")
        nbytes = sum(x.numel() * x.element_size() for x in got)
        ms = cuda_ms(lambda: fetch(step(*args)))
        kept = int(got[2]) if name == "packed" else int((got[1] > 0).sum())
        check(kept > 0, f"kmer batch step ({name}): no sample-only k-mers")
        print(f"  kmer batch step {name}: CUDA == CPU, {kept} kept k-mers; step + fetch "
              f"{ms:.4f} ms, fetch {nbytes} bytes [{card}]", flush=True)


# int16 operations an element of the fused mini-recurrence: substitution 2,
# clamp 1, first E 3, then three rounds of E 3 and H 3 (the roll moves data)
MINI_OPS = 24
I16_LIBRARY = {  # int16 probe op: the one torch call computing the same function
    "i16 maximum": torch.maximum, "i16 minimum": torch.minimum, "i16 add": torch.add,
    "i16 sub const": lambda a: torch.sub(a, 6), "i16 mul": torch.mul,
    "i32->i16 astype": lambda a: a.to(torch.int16),
    "i16->i32 astype": lambda a: a.to(torch.int32),
    "i16 compare-select": torch.maximum, "i16 roll (lanes)": lambda a: torch.roll(a, 1, 1),
    "i16 sub tensor": torch.sub, "i16 ashr 15": lambda a: torch.bitwise_right_shift(a, 15),
    "i16 shl 1": lambda a: torch.bitwise_left_shift(a, 1),
    "i16 add splat-int16": lambda a: torch.add(a, 6), "i16 add py-int": lambda a: torch.add(a, 6),
    "i16 add full-array const": lambda a: torch.add(a, 6), "i16 emulated max": torch.maximum,
}
I16_CALL_TARGET = 1.25  # a kernel call's time over its one torch call's, at most
LAUNCH_STEP_CALLS = 1000


def launch_path_steps(dev, card):
    """The int16 probe's launch path on ``i16 maximum`` at [16, 256], step
    by step: each step run LAUNCH_STEP_CALLS times alone (host clock, µs
    a call), first the steps of the path the wrapper had before the lean
    one (generator checks over ``torch.device`` objects, ``.contiguous()``
    and a pointer list, ``torch.empty``, ``_build.library()``, the
    ``torch.cuda.device`` context, a ``Stream`` object for the handle, the
    ctypes call, ``check_launch`` on every call), then the lean path's.
    Returns {"former": µs, "lean": µs} of a whole call."""
    from breakmer_tpu_torch import _build
    from breakmer_tpu_torch.tools import probe_swar_i16 as i16

    op = i16.OPS[0]
    x = {k: torch.from_numpy(v).to(dev) for k, v in i16.inputs().items()}
    xs = [x[a] for a in op.args]
    x0 = xs[0]
    index = x0.get_device()
    R, W = x0.shape
    rw = i16.plan(W).per_thread
    lib = _build.library()
    fn = lib.probe_i16_launch
    out = torch.empty((R, W), dtype=op.out_dtype, device=dev)
    ptrs = [x.data_ptr() for x in xs] + [None]
    stream = torch.cuda.current_stream(x0.device).cuda_stream

    def stream_of(x):  # the former path's handle: a Stream object built each call
        return torch.cuda.current_stream(x.device).cuda_stream

    def former_import():
        from breakmer_tpu_torch import _build  # noqa: F401

    def former_context():
        with torch.cuda.device(x0.device):
            pass

    def former_call():  # the whole former path, as it ran
        all(x.device.type == "cpu" for x in xs)
        from breakmer_tpu_torch import _build as b
        x0 = xs[0]
        if any(x.device != x0.device for x in xs) or x0.device.type != "cuda":
            raise SmokeFailure("device")
        R, W = x0.shape
        if R % 2 or not 1 <= W <= 1024 or any(x.shape != x0.shape for x in xs):
            raise SmokeFailure("shape")
        if any(x.dtype != op.in_dtype for x in xs):
            raise SmokeFailure("dtype")
        ys = [x.contiguous() for x in xs]
        ps = [y.data_ptr() for y in ys] + [None] * (3 - len(ys))
        o = torch.empty((R, W), dtype=op.out_dtype, device=x0.device)
        lib = b.library()
        with torch.cuda.device(x0.device):
            err = lib.probe_i16_launch(op.op_id, *ps, o.data_ptr(), R, W, rw, stream_of(x0))
        b.check_launch(err, f"probe_i16 ({op.name})")

    def lean_checks():
        index, shape = x0.get_device(), x0.shape
        for x in xs:
            if (x.get_device() != index or x.dtype is not op.in_dtype or x.shape != shape
                    or not x.is_contiguous()):
                raise SmokeFailure("lean checks")

    steps = [
        ("former: CPU check (generator over .device.type)",
         lambda: all(x.device.type == "cpu" for x in xs)),
        ("former: import of _build in the call", former_import),
        ("former: device checks (generators, torch.device ==)",
         lambda: any(x.device != x0.device for x in xs) or x0.device.type != "cuda"),
        ("former: shape checks (generator)",
         lambda: R % 2 or not 1 <= W <= 1024 or any(x.shape != x0.shape for x in xs)),
        ("former: dtype checks (generator)", lambda: any(x.dtype != op.in_dtype for x in xs)),
        ("former: .contiguous() and the pointer list",
         lambda: [y.data_ptr() for y in [x.contiguous() for x in xs]] + [None]),
        ("former: torch.empty output",
         lambda: torch.empty((R, W), dtype=op.out_dtype, device=x0.device)),
        ("former: _build.library()", _build.library),
        ("former: torch.cuda.device context (enter, exit)", former_context),
        ("former: the stream's handle (a Stream object)", lambda: stream_of(x0)),
        ("ctypes launch (9 arguments, launches)",
         lambda: lib.probe_i16_launch(op.op_id, *ptrs, out.data_ptr(), R, W, rw, stream)),
        ("former: check_launch(0) with its f-string",
         lambda: _build.check_launch(0, f"probe_i16 ({op.name})")),
        ("former: the whole path (launches)", former_call),
        ("lean: checks (get_device, dtype is, shape, is_contiguous)", lean_checks),
        ("lean: plan(W) (cached)", lambda: i16.plan(W)),
        ("lean: new_empty output", lambda: x0.new_empty((R, W), dtype=op.out_dtype)),
        ("lean: torch.empty_like output", lambda: torch.empty_like(x0)),
        ("lean: torch.empty_like output, dtype given",
         lambda: torch.empty_like(x0, dtype=torch.int32)),
        ("ctypes call refused in C (op -1, no launch)",
         lambda: fn(-1, *ptrs, out.data_ptr(), R, W, rw, stream)),
        ("lean: torch._C._cuda_getDevice()", torch._C._cuda_getDevice),
        ("lean: raw current stream", lambda: torch._C._cuda_getCurrentRawStream(index)),
        ("lean: _build.launch (launches)",
         lambda: _build.launch(fn, index, op.name, op.op_id, *ptrs, out.data_ptr(), R, W, rw)),
        ("lean: probe_swar_i16.launch (launches)", lambda: i16.launch(op, *xs)),
        ("torch.maximum, the library call", lambda: torch.maximum(*xs)),
    ]
    us = host_steps_us(steps, card)
    return {"former": us["former: the whole path (launches)"],
            "lean": us["lean: probe_swar_i16.launch (launches)"]}


def host_steps_us(steps, card, label="launch path step") -> dict:
    """Each (name, step) of ``steps`` run LAUNCH_STEP_CALLS times alone
    after one warm-up call: {name: µs a call on the host clock}."""
    us = {}
    for name, step in steps:
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LAUNCH_STEP_CALLS):
            step()
        us[name] = (time.perf_counter() - t0) / LAUNCH_STEP_CALLS * 1e6
        torch.cuda.synchronize()
        print(f"  {label} {name:58s} {us[name]:8.3f} us a call "
              f"({LAUNCH_STEP_CALLS} calls, host clock) [{card}]", flush=True)
    return us


def i16_turns(mod, dev, card):
    """Each op of ``mod`` (an int16 probe) with a one-call torch
    counterpart: a call's time of the kernel and of that call in turns
    (``turns_us``), their ratio against I16_CALL_TARGET, and the device
    time of both (profiler and queued calls). Returns {op name: [kernel
    µs, torch µs, ratio]}."""
    from breakmer_tpu_torch.timing import device_us, queued_ms, turns_us

    x = {k: torch.from_numpy(v).to(dev) for k, v in mod.inputs().items()}
    ratios = {}
    for op in mod.OPS:
        lib = I16_LIBRARY.get(op.name)
        if lib is None:
            continue
        args = [x[a] for a in op.args]
        kern = lambda: mod.run_op(op, *args)  # noqa: E731
        torch_call = lambda: lib(*args)  # noqa: E731
        k_us, t_us = turns_us(kern, torch_call)
        ratio = k_us / t_us
        ratios[op.name] = [k_us, t_us, ratio]
        print(f"  {mod.__name__.rsplit('.', 1)[1]} {op.name:26s} a call: kernel {k_us:.2f} us, "
              f"torch {t_us:.2f} us, ratio {ratio:.3f} "
              f"({'within' if ratio <= I16_CALL_TARGET else 'over'} {I16_CALL_TARGET}); "
              f"device us kernel {device_us(kern):.2f} (queued {queued_ms(kern) * 1e3:.2f}), "
              f"torch {device_us(torch_call):.2f} (queued {queued_ms(torch_call) * 1e3:.2f}) "
              f"[{card}]", flush=True)
    return ratios


def phase_probes(dev, card):
    """Each probe kernel against its plain version at the probes' shapes,
    with a call's time (CUDA events), its device time (queued calls,
    ``timing.queued_ms``; the profiler's too for the short kernels), its
    bound and, where one torch call computes the same function, that
    call's time; the ceiling probe's rolls0 and roll_bound_fraction
    against the SW kernel at its shape; the int16 probe's launch path
    step by step; the running max as ``cummax_row`` measures it: (kernel
    rows for the table, keyed by kernel name)."""
    from breakmer_tpu_torch.timing import cuda_ms
    from breakmer_tpu_torch.tools import probe_swar_i16 as i16
    from breakmer_tpu_torch.tools import probe_swar_i16b as i16b
    from breakmer_tpu_torch.tools import sw_ceiling_probe as ceil

    rows = {}
    ceil.check(dev)  # raises on any difference
    q, t = ceil.inputs(dev)
    steps = ceil.default_steps(ceil.LQ, ceil.LT)
    m = ceil.measure(dev)  # queued device times: rolls3, rolls0, the SW kernel
    row = rows["sw_ceiling_probe"] = dict(  # rolls3, the form that strips the SW kernel
        max_abs_err=0, shape=[ceil.B, ceil.LQ, ceil.LT],
        ms=cuda_ms(lambda: ceil.stripped(q, t, True)), device_ms=m["rolls3_s"] * 1e3,
        plain_ms=cuda_ms(lambda: ceil.stripped_plain(q, t, True)), library_ms=None,
        rolls0_device_ms=m["rolls0_s"] * 1e3, sw_full_device_ms=m["full_s"] * 1e3,
        roll_bound_fraction=m["roll_bound_fraction"],
        # h = max of four values a lane a step: two instructions on this card,
        # whose VIMNMX3 takes three inputs (the kernel's step compiles to
        # SHFL, VIMNMX3 and VIMNMX alone); three two-input maxes would read
        # 1.5x this bound
        bound=bound(ceil.B * (ceil.LQ + ceil.LT) + 4 * ceil.B * ceil.LQ,
                    int32_ops=2 * ceil.B * ceil.LQ * steps))
    max3_ms = bound(0, int32_ops=3 * ceil.B * ceil.LQ * steps)[0]
    print(f"  ceiling probe: kernel == plain, both forms, steps 1/7/255/{steps}; R "
          f"{ceil.plan(ceil.LQ).per_thread}; rolls3 {row['device_ms']:.4f} ms on the device "
          f"({row['bound'][0] / row['device_ms']:.1%} of the {row['bound'][0]:.4f} ms bound "
          f"at 2 instructions a lane a step; {max3_ms / row['device_ms']:.1%} of "
          f"{max3_ms:.4f} ms at 3 two-input maxes), "
          f"{row['ms']:.4f} ms a call; rolls0 {row['rolls0_device_ms']:.4f} ms; SW kernel "
          f"(no_n) {row['sw_full_device_ms']:.4f} ms; roll_bound_fraction "
          f"{row['roll_bound_fraction']:.4f}; plain {row['plain_ms']:.2f} ms [{card}]",
          flush=True)
    launch_us = launch_path_steps(dev, card)
    for name, mod in (("probe_i16", i16), ("probe_i16b", i16b)):
        ops = mod.run_ops(mod.OPS, mod.run_op, mod.inputs(), dev)
        bad = [r["name"] for r in ops if not r["exact"]]
        check(not bad, f"{name}: kernel != plain for {bad}")
        for r in ops:
            print(f"  {name} {r['name']:32s} exact  kernel {r['us']:.2f} us "
                  f"({r['device_us']:.2f} device, {r['queued_us']:.2f} queued)  plain "
                  f"{r['plain_us']:.2f} us ({r['plain_device_us']:.2f} device, "
                  f"{r['plain_queued_us']:.2f} queued) [{card}]", flush=True)
        ratios = i16_turns(mod, dev, card)
        mini = next(r for r in ops if r["name"].startswith("fused mini"))
        n = i16.SHAPE[0] * i16.SHAPE[1]
        rows[name] = dict(max_abs_err=max(r["max_abs_err"] for r in ops),
                          shape=list(i16.SHAPE), op=mini["name"],
                          ms=mini["us"] / 1e3, plain_ms=mini["plain_us"] / 1e3,
                          device_ms=mini["queued_us"] / 1e3,
                          profiler_device_ms=mini["device_us"] / 1e3,
                          plain_device_ms=mini["plain_device_us"] / 1e3,
                          library_ms=None,  # no one torch call runs the recurrence
                          library_call_ratio=ratios, launch_path_us=launch_us,
                          bound=bound(2 * 4 * n + 2 * n, int16_ops=MINI_OPS * n))
        over = {k: round(v[2], 3) for k, v in ratios.items() if v[2] > I16_CALL_TARGET}
        print(f"  {name}: {len(ratios)} ops with a torch counterpart, a call at most "
              f"{max(v[2] for v in ratios.values()):.3f}x the torch call's; over "
              f"{I16_CALL_TARGET}: {over or 'none'}", flush=True)
    rows["probe_cummax"] = cummax_row(dev, card)
    for name, row in rows.items():
        print(f"  {name}: bound {row['bound'][0]:.3g} ms ({row['bound'][1]}); device "
              f"{row['device_ms']:.4g} ms (queued), a call {row['ms']:.4g} ms", flush=True)
    torch.cuda.synchronize()
    return rows


CUMMAX_BANDWIDTH_SHAPES = [(16384, 1024), (65536, 256)]  # 64 MiB in, 64 MiB out each
CUMMAX_CALL_TARGET = 1.0   # a kernel call's time over torch.cummax's, at most
CUMMAX_SHARE_TARGET = 0.5  # the bound's share of the device time, at least
CUMMAX_WARPS = (1, 2, 4, 8)


def cummax_row(dev, card):
    """The running-max kernel against its plain version: at the probe's
    [8, 256] through ``measure`` (a call and the profiler's device time),
    queued calls, a call in turns with torch.cummax (the ratio against
    CUMMAX_CALL_TARGET) and the host's launch path step by step; at each
    of CUMMAX_BANDWIDTH_SHAPES (full-range int32 from seed 8) exact, the
    queued and profiler device times of the kernel and of torch.cummax,
    a device copy of the input (``copy_``: the same bytes, no scan) and
    the bound's share against CUMMAX_SHARE_TARGET; at every shape the
    kernel at each forced warps a block beside the plan's. Returns the
    kernel's row for the table."""
    from breakmer_tpu_torch import _build
    from breakmer_tpu_torch.timing import cuda_ms, device_us, queued_ms, turns_us
    from breakmer_tpu_torch.tools import probe_mosaic_cummax as cm

    def lib(x):
        return torch.cummax(x, dim=-1)

    def by_warps(x):
        return {w: queued_ms(lambda: cm.cummax(x, warps=w)) * 1e3 for w in CUMMAX_WARPS}

    r = cm.measure(dev)
    check(r["exact"], "cummax kernel != plain")
    x = torch.from_numpy(cm.inputs()).to(dev)
    lib_us = cuda_ms(lambda: lib(x), reps=20) * 1e3
    lib_dev = device_us(lambda: lib(x))
    queued_us = queued_ms(lambda: cm.cummax(x)) * 1e3
    lib_queued_us = queued_ms(lambda: lib(x)) * 1e3
    k_us, t_us = turns_us(lambda: cm.cummax(x), lambda: lib(x))
    ratio = k_us / t_us
    warps_us = {str(cm.SHAPE): by_warps(x)}
    n = cm.SHAPE[0] * cm.SHAPE[1]
    print(f"  cummax {cm.SHAPE}: exact; plan {tuple(cm.plan(*cm.SHAPE))}; kernel "
          f"{r['us']:.2f} us ({r['device_us']:.2f} device, {queued_us:.2f} queued), plain "
          f"{r['plain_us']:.2f} us ({r['plain_device_us']:.2f} device), torch.cummax "
          f"{lib_us:.2f} us ({lib_dev:.2f} device, {lib_queued_us:.2f} queued); a call in "
          f"turns: kernel {k_us:.2f} us, torch.cummax {t_us:.2f} us, ratio {ratio:.3f} "
          f"({'within' if ratio <= CUMMAX_CALL_TARGET else 'over'} {CUMMAX_CALL_TARGET}); "
          f"queued us by warps a block {warps_us[str(cm.SHAPE)]} [{card}]", flush=True)
    p = cm.plan(*x.shape)
    fn = _build.library().probe_cummax_launch
    out = torch.empty_like(x)
    index = x.get_device()
    launch_us = host_steps_us([
        ("checks (is_cuda, dtype is, dim, shape, is_contiguous)",
         lambda: (x.is_cuda, x.dtype is torch.int32, x.dim() == 2, 1 <= x.shape[1] <= 1024,
                  x.is_contiguous())),
        ("torch.empty_like output", lambda: torch.empty_like(x)),
        ("x.new_empty output", lambda: x.new_empty((8, 256))),
        ("plan(R, W) (cached)", lambda: cm.plan(8, 256)),
        ("torch._C._cuda_getDevice()", torch._C._cuda_getDevice),
        ("raw current stream", lambda: torch._C._cuda_getCurrentRawStream(index)),
        ("_build.launch (launches)",
         lambda: _build.launch(fn, index, "probe_cummax", x.data_ptr(), out.data_ptr(),
                               8, 256, p.per_thread, p.warps)),
        ("cummax, the whole wrapper (launches)", lambda: cm.cummax(x)),
        ("torch.cummax, the library call", lambda: lib(x)),
    ], card, "cummax launch path step")
    bandwidth = []
    for R, W in CUMMAX_BANDWIDTH_SHAPES:
        xb = torch.from_numpy(np.random.default_rng(8).integers(
            -2**31, 2**31, (R, W), dtype=np.int64).astype(np.int32)).to(dev)
        err = int((cm.cummax(xb).long() - cm.cummax_plain(xb).long()).abs().max())
        check(err == 0, f"cummax kernel != plain at {(R, W)}")
        b_ms, b_by = bound(8 * R * W, int32_ops=R * W)
        k_dev = queued_ms(lambda: cm.cummax(xb)) * 1e3
        copy = torch.empty_like(xb)
        row = dict(shape=[R, W], max_abs_err=err, plan=list(cm.plan(R, W)),
                   device_us=k_dev, profiler_device_us=device_us(lambda: cm.cummax(xb)),
                   library_device_us=queued_ms(lambda: lib(xb)) * 1e3,
                   library_profiler_device_us=device_us(lambda: lib(xb)),
                   copy_device_us=queued_ms(lambda: copy.copy_(xb)) * 1e3,
                   bound_us=b_ms * 1e3, bound_by=b_by, bound_share=b_ms * 1e3 / k_dev)
        warps_us[str((R, W))] = by_warps(xb)
        bandwidth.append(row)
        print(f"  cummax {(R, W)}: exact; plan {tuple(cm.plan(R, W))}; kernel "
              f"{k_dev:.2f} us on the device ({row['profiler_device_us']:.2f} profiler), "
              f"torch.cummax {row['library_device_us']:.2f} us "
              f"({row['library_profiler_device_us']:.2f} profiler), a device copy of the "
              f"input {row['copy_device_us']:.2f} us; bound {b_ms * 1e3:.2f} "
              f"us ({b_by}), {row['bound_share']:.1%} of it "
              f"({'within' if row['bound_share'] >= CUMMAX_SHARE_TARGET else 'under'} "
              f"{CUMMAX_SHARE_TARGET:.0%}); queued us by warps a block "
              f"{warps_us[str((R, W))]} [{card}]", flush=True)
        del xb, copy
    return dict(max_abs_err=r["max_abs_err"], shape=list(cm.SHAPE),
                ms=r["us"] / 1e3, plain_ms=r["plain_us"] / 1e3,
                device_ms=queued_us / 1e3, profiler_device_ms=r["device_us"] / 1e3,
                plain_device_ms=r["plain_device_us"] / 1e3,
                library_ms=lib_us / 1e3, library_device_ms=lib_dev / 1e3,
                library_call_ratio={str(cm.SHAPE): [k_us, t_us, ratio]},
                launch_path_us=launch_us, warps_device_us=warps_us,
                bandwidth_shapes=bandwidth, bound=bound(8 * n, int32_ops=n))


def tiled_region_inputs(G, R, L, LREF, GB, GLQ, GLT, RN=0, NOVEL=None, seed=3):
    """Region-step inputs whose reads tile a haplotype (about 8x at the
    bench's shape) that shares only its first half with the reference
    (and its tail past NOVEL bases, if given), so many sample-only
    k-mers pass min_count; SW pairs are random. ``RN`` > 0 appends a
    matched normal of RN reads tiled over the haplotype up to half its
    novel bases, all PAD in region 0, and its lengths."""
    NOVEL = LREF - LREF // 2 if NOVEL is None else NOVEL
    rng = np.random.default_rng(seed)
    hap = rng.integers(0, 4, (G, LREF)).astype(np.int8)
    refs = hap.copy()
    refs[:, LREF // 2:LREF // 2 + NOVEL] = rng.integers(0, 4, (G, NOVEL))

    def tile(n, hi):
        starts = rng.integers(0, hi - L + 1, (G, n))
        return hap[np.arange(G)[:, None, None], starts[:, :, None] + np.arange(L)]

    out = (tile(R, LREF), np.full((G, R), L, np.int32), refs, np.full(G, LREF, np.int32),
           rng.integers(0, 4, (G, GB, GLQ)).astype(np.int8),
           rng.integers(0, 4, (G, GB, GLT)).astype(np.int8))
    if RN:
        normal = tile(RN, LREF // 2 + NOVEL // 2)
        normal_lengths = np.full((G, RN), L, np.int32)
        normal[0], normal_lengths[0] = 4, 0
        out += (normal, normal_lengths)
    return out


def phase_region_step(dev, card):
    """The region step on the card against the CPU at the bench's shape,
    on the bench's inputs and on tiled reads."""
    from breakmer_tpu_torch import bench
    from breakmer_tpu_torch.parallel.step import make_region_step, to_numpy

    step = make_region_step(mesh=None, k=bench.K)
    tiled = tiled_region_inputs(bench.G, bench.R, bench.L, bench.LREF, bench.GB,
                                bench.GLQ, bench.GLT)
    for label, on in (("bench inputs", bench.region_step_inputs),
                      ("tiled reads", lambda d: tuple(torch.from_numpy(a).to(d)
                                                      for a in tiled))):
        got = to_numpy(step(*on(dev)))
        torch.cuda.synchronize()
        want = to_numpy(step(*on("cpu")))
        for name, a, b in zip(("values", "counts", "scores", "q_end", "t_end"), want, got):
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"region step {name} ({label}): CUDA != CPU")
        print(f"  region step G={bench.G} R={bench.R} L={bench.L} LREF={bench.LREF} "
              f"pairs {bench.GB}x{bench.GLQ}x{bench.GLT}, {label}: CUDA == CPU "
              f"({int((want[1] > 0).sum())} kept k-mers) [{card}]", flush=True)


def phase_measurement_path():
    """The measurement path as a user runs it; returns each probe
    kernel's launches in it."""
    from breakmer_tpu_torch import bench, bench_panel
    from breakmer_tpu_torch.tools import probe_mosaic_cummax as cm
    from breakmer_tpu_torch.tools import probe_swar_i16 as i16
    from breakmer_tpu_torch.tools import probe_swar_i16b as i16b
    from breakmer_tpu_torch.tools import sw_ceiling_probe as ceil

    counted = {"sw_ceiling_probe": ceil, "probe_i16": i16, "probe_i16b": i16b,
               "probe_cummax": cm}
    for mod in counted.values():
        mod.LAUNCHES = 0  # the measurement path starts here
    for mod in (bench, ceil, i16, i16b, cm):
        t0 = time.perf_counter()
        mod.main()
        torch.cuda.synchronize()
        print(f"  {mod.__name__}.main: {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {name: mod.LAUNCHES for name, mod in counted.items()}
    t0 = time.perf_counter()
    bench_panel.main([])
    print(f"  breakmer_tpu_torch.bench_panel.main: {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, n in launches.items():
        check(n > 0, f"the measurement path launched {name} no time")
    return launches


def card0() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device())


def same_arrays(want, got) -> bool:
    return all(a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
               for a, b in zip(want, got))


def phase_sharded_region_step(card):
    """The region step over a virtual (2, 2) mesh on the card, exact
    against the unsharded CUDA step and the CPU step at the bench's shape
    (bench inputs and tiled reads); one SW launch a shard a step; ms a
    step (CUDA events) and device ms (``timing.device_us``) of both forms.
    Returns the SW launches of one sharded step."""
    from breakmer_tpu_torch import bench
    from breakmer_tpu_torch.ops import sw_cuda
    from breakmer_tpu_torch.parallel.mesh import make_mesh_2d
    from breakmer_tpu_torch.parallel.step import make_region_step, to_numpy
    from breakmer_tpu_torch.timing import cuda_ms, device_us

    dev = card0()
    mesh = make_mesh_2d(devices=[dev] * 4)
    check(mesh.devices.shape == (2, 2), f"mesh {mesh}")
    single = make_region_step(mesh=None, k=bench.K)
    sharded = make_region_step(mesh=mesh, k=bench.K)
    tiled = tiled_region_inputs(bench.G, bench.R, bench.L, bench.LREF, bench.GB,
                                bench.GLQ, bench.GLT)
    step_launches = 0
    for label, host in (("bench inputs", bench.region_step_inputs("cpu")),
                        ("tiled reads", tuple(torch.from_numpy(a) for a in tiled))):
        inputs = tuple(x.to(dev) for x in host)
        sw_cuda.LAUNCHES = 0  # one sharded step starts here
        got = sharded(*inputs)
        torch.cuda.synchronize()
        step_launches = sw_cuda.LAUNCHES
        check(step_launches == 4, f"sharded region step: {step_launches} SW launches, not 4")
        check(all(x.device == mesh.first for x in got), "sharded step outputs off the first device")
        got = to_numpy(got)
        check(same_arrays(to_numpy(single(*host)), got), f"sharded region step ({label}) != CPU")
        check(same_arrays(to_numpy(single(*inputs)), got),
              f"sharded region step ({label}) != the unsharded CUDA step")
        print(f"  sharded region step 2x2 on {dev}, {label}: == unsharded CUDA == CPU, "
              f"{step_launches} SW launches a step [{card}]", flush=True)
    for label, fn in (("unsharded", single), ("sharded 2x2", sharded)):
        ms = cuda_ms(lambda: fn(*inputs))
        dms = device_us(lambda: fn(*inputs), n=10) / 1e3
        print(f"  region step {label}: {ms:.4f} ms a step (events), {dms:.4f} ms device "
              f"[{card}]", flush=True)
    return step_launches


def phase_sharded_kmer_batch_step(card):
    """The k-mer batch step at phase 9's shapes over a virtual (2, 2) mesh
    on the card, full and packed, exact against the unsharded CUDA step
    and the CPU step; each timed with its fetch."""
    from breakmer_tpu_torch.parallel import kmer_batch as kb
    from breakmer_tpu_torch.parallel.mesh import make_mesh_2d
    from breakmer_tpu_torch.timing import cuda_ms

    dev = card0()
    G, R, L, LREF, RN = 32, 512, 128, 4096, 256
    tiled = tiled_region_inputs(G, R, L, LREF, 0, 1, 1, RN=RN, NOVEL=256)
    arrays = tiled[:4] + tiled[6:]
    host = tuple(torch.from_numpy(a) for a in arrays)
    args = tuple(a.to(dev) for a in host)
    mesh = make_mesh_2d(devices=[dev] * 4)
    blocks, _pinned = kb._upload_sharded(arrays, mesh)
    cap = G * kb._PACK_SLOTS_PER_REGION
    forms = {"full": (kb._kmer_body(15, 2), kb._kmer_body(15, 2, mesh), kb._fetch_full),
             "packed": (kb._kmer_step_packed(15, 2, cap), kb._kmer_step_packed(15, 2, cap, mesh),
                        lambda o: kb._fetch_packed([o]))}
    for name, (single, sharded, fetch) in forms.items():
        want, cuda, got = single(*host), single(*args), sharded(*blocks)
        torch.cuda.synchronize()
        for a, b, c in zip(want, cuda, got):
            check(a.dtype == c.dtype and torch.equal(a, c.cpu()),
                  f"sharded kmer batch step ({name}) != CPU")
            check(torch.equal(b, c), f"sharded kmer batch step ({name}) != unsharded CUDA")
        kept = int(got[2]) if name == "packed" else int((got[1] > 0).sum())
        check(kept > 0, f"sharded kmer batch step ({name}): no sample-only k-mers")
        ms = cuda_ms(lambda: fetch(sharded(*blocks)))
        one = cuda_ms(lambda: fetch(single(*args)))
        print(f"  sharded kmer batch step {name} G={G} over 2x2 on {dev}: == unsharded CUDA "
              f"== CPU, {kept} kept k-mers; step + fetch {ms:.4f} ms (unsharded {one:.4f} ms) "
              f"[{card}]", flush=True)


def phase_mesh_runner(card, panel, batched_rate):
    """The batched runner on the 100-gene panel under
    ``device.virtual_devices([cuda:0] * 4)``: its k-mer launches go
    through a (2, 2) mesh. Twice (the second run timed as warm); svs.out
    and the VCF byte-identical to phase 6's serial CUDA output. Returns
    the warm run's SW launches."""
    from breakmer_tpu_torch.device import virtual_devices
    from breakmer_tpu_torch.ops import sw_cuda
    from breakmer_tpu_torch.utils.meter import METER

    cfg_kwargs, _, work = panel
    serial = {name: (work / "cuda" / "output" / name).read_bytes() for name in OUTPUTS}
    kw = {**cfg_kwargs, "batch_regions": True, "nprocs": 1}
    launches = 0
    for label in ("first", "warm"):
        out = work / f"mesh_{label}"
        sw_cuda.LAUNCHES = 0  # this run of the mesh runner starts here
        with virtual_devices([card0()] * 4):
            events, metrics, setup_s, run_s, runner = run_panel(kw, out, "cuda")
        launches = sw_cuda.LAUNCHES
        kb = runner.kmer_pipeline
        check(kb.mesh is not None and kb.mesh.devices.size == 4,
              f"mesh runner {label}: the k-mer pipeline ran on {kb.mesh}")
        check(launches > 0 and launches == METER.sw_launches,
              f"mesh runner {label}: SW launches {launches} != SW batches {METER.sw_launches}")
        for name in OUTPUTS:
            check((out / "output" / name).read_bytes() == serial[name],
                  f"mesh runner {label} {name} != the serial CUDA output")
        n_regions = metrics["targets"]
        print(f"  batched panel100 over the 2x2 mesh ({label}): {len(events)} calls in "
              f"{run_s:.4f} s: {n_regions / run_s:.2f} regions/s (phase 8 warm, one device: "
              f"{batched_rate:.2f}); {kb.dispatched} packed k-mer launches of {kb.rpb} regions, "
              f"kmer_device {metrics['stage_s'].get('kmer_device', 0.0):.4f} s; SW {launches} "
              f"launches; svs.out and VCF == serial [{card}]", flush=True)
    return launches


def genome_at_scale(rng, n_chrom=24, chrom_len=12_500_000, seg_len=5_000):
    """{chrom: int8 codes}: ``n_chrom`` random chromosomes with one
    ``seg_len`` segment copied into each, at a multiple of the index's step
    (k = 11), so that its seeds form runs over every chromosome."""
    segment = rng.integers(0, 4, seg_len).astype(np.int8)
    genome = {}
    for c in range(n_chrom):
        codes = rng.integers(0, 4, chrom_len).astype(np.int8)
        at = 11 * int(rng.integers(0, (chrom_len - seg_len) // 11))
        codes[at:at + seg_len] = segment
        genome[f"chr{c + 1}"] = codes
    return genome, segment


def index_contigs(rng, genome, segment, n=2000, length=250):
    """``n`` contigs of ``length``: a quarter reverse-complemented, a
    quarter split across two chromosomes, one in eight from the shared
    segment, the rest forward."""
    from breakmer_tpu_torch.encode import revcomp_codes

    names = list(genome)
    out = []
    for i in range(n):
        a, b = (genome[names[j]] for j in rng.choice(len(names), 2, replace=False))
        s = int(rng.integers(0, len(a) - length))
        contig = a[s:s + length].copy()
        if i % 4 == 1:
            contig = revcomp_codes(contig)
        elif i % 4 == 2:
            t = int(rng.integers(0, len(b) - length))
            contig[length // 2:] = b[t:t + length - length // 2]
        elif i % 8 == 3:
            s = int(rng.integers(0, len(segment) - length))
            contig = segment[s:s + length].copy()
        out.append(contig)
    return out


def phase_sharded_index(card, panel):
    """A seed table of a ~300 Mbp genome range-sharded over [cuda:0] * 4
    and over [cuda:0]: 2,000 contigs' candidate windows equal
    GenomeIndex.candidates; then the Runner on the 100-gene panel with
    shard_genome_index over [cuda:0] * 4, byte-identical to phase 6.
    Returns that run's SW launches."""
    from breakmer_tpu_torch.align.index import GenomeIndex
    from breakmer_tpu_torch.device import virtual_devices
    from breakmer_tpu_torch.ops import sw_cuda
    from breakmer_tpu_torch.parallel.index_shard import ShardedGenomeIndex, make_shard_mesh

    dev = card0()
    rng = np.random.default_rng(17)
    t0 = time.perf_counter()
    genome, segment = genome_at_scale(rng)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gi = GenomeIndex(genome, k=11)
    build_s = time.perf_counter() - t0
    bp = sum(len(c) for c in genome.values())
    check(gi.step == 11, f"genome index step {gi.step}, expected 11")
    print(f"  genome {len(genome)} chromosomes, {bp} bp (generated in {gen_s:.1f} s); "
          f"GenomeIndex k=11 step {gi.step}: {len(gi._positions)} seeds, built in "
          f"{build_s:.1f} s (host)", flush=True)
    contigs = index_contigs(rng, genome, segment)
    del genome
    key = lambda ws: [(w.chrom, w.t_start, w.t_end, w.strand, w.nseeds) for w in ws]  # noqa: E731
    t0 = time.perf_counter()
    want = [key(gi.candidates(q)) for q in contigs]
    host_ms = (time.perf_counter() - t0) * 1e3 / len(contigs)
    check(sum(map(len, want)) > len(contigs), "host index: too few candidate windows")
    for D in (4, 1):
        t0 = time.perf_counter()
        si = ShardedGenomeIndex(gi, make_shard_mesh(devices=[dev] * D))
        torch.cuda.synchronize()
        ctor_s = time.perf_counter() - t0
        host_copies = [x.cpu() for shard in si.shards for x in shard]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = [h.to(dev) for h in host_copies]
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        del again, host_copies
        si.candidates(contigs[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [key(si.candidates(q)) for q in contigs]
        ms = (time.perf_counter() - t0) * 1e3 / len(contigs)
        bad = sum(a != b for a, b in zip(want, got))
        check(bad == 0, f"sharded index D={D}: {bad} of {len(contigs)} contigs' windows "
                        "differ from GenomeIndex.candidates")
        print(f"  sharded index D={D} on {dev}: h_pad {si.h_pad}, {si.shard_nbytes} bytes a "
              f"shard ({D * si.shard_nbytes} on the card); table build + upload {ctor_s:.2f} s "
              f"(upload of the same bytes again {upload_s:.3f} s); {len(contigs)} contigs' "
              f"windows == GenomeIndex: {ms:.3f} ms a contig (host index {host_ms:.3f} ms) "
              f"[{card}]", flush=True)
        del si
        torch.cuda.empty_cache()
    del gi
    cfg_kwargs, _, work = panel
    out = work / "sharded_index"
    sw_cuda.LAUNCHES = 0  # this run of the sharded-index runner starts here
    with virtual_devices([dev] * 4):
        _, metrics, setup_s, run_s, runner = run_panel(
            {**cfg_kwargs, "batch_regions": False, "shard_genome_index": True}, out, "cuda")
    launches = sw_cuda.LAUNCHES
    check(isinstance(runner.genome, ShardedGenomeIndex) and runner.genome.mesh.devices.size == 4,
          f"shard_genome_index: runner.genome is {type(runner.genome).__name__}")
    check(launches > 0, "sharded-index runner: the SW kernel launched no time")
    for name in OUTPUTS:
        serial = (work / "cuda" / "output" / name).read_bytes()
        check((out / "output" / name).read_bytes() == serial,
              f"sharded-index runner {name} != the serial CUDA output")
    print(f"  panel100 serial with the seed table sharded over 4: {metrics['targets'] / run_s:.2f} "
          f"regions/s (setup {setup_s:.2f} s); SW {launches} launches; svs.out and VCF == "
          f"serial [{card}]", flush=True)
    return launches


MH_WORKER = r"""
import json, sys, time
from pathlib import Path
import torch
from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.ops import sw_cuda
from breakmer_tpu_torch.runner import Runner

cfg_file, pid, port, n = sys.argv[1], int(sys.argv[2]), sys.argv[3], int(sys.argv[4])
cfg = Config(**{**json.loads(Path(cfg_file).read_text()), "multihost": n > 1,
                "num_processes": n, "process_id": pid,
                "coordinator_address": f"127.0.0.1:{port}"})
t0 = time.perf_counter()
r = Runner(cfg)
r.setup()
r.run()
torch.cuda.synchronize()
print(json.dumps({"worker": pid, "targets": len(r.targets), "of": len(r.all_target_names),
                  "sw_launches": sw_cuda.LAUNCHES, "run_s": time.perf_counter() - t0}))
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_workers(cfg_file: Path, out: Path, n: int, timeout: float = 300):
    """``n`` worker processes of MH_WORKER on the card, writing under
    ``out``; (wall s, [their JSON lines]). A second port is tried once if
    the first fails; a worker still running at the timeout is killed by
    its PID."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for attempt in (0, 1):
        shutil.rmtree(out, ignore_errors=True)
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", MH_WORKER, str(cfg_file), str(p),
                                   str(port), str(n)], cwd=str(ROOT), env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for p in range(n)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=max(1.0, t0 + timeout - time.perf_counter())))
        except subprocess.TimeoutExpired:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.communicate()
            raise SmokeFailure(f"multihost workers still running after {timeout} s")
        wall = time.perf_counter() - t0
        if all(p.returncode == 0 for p in procs):
            return wall, [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
        if attempt == 1:
            raise SmokeFailure("multihost workers failed: " + " | ".join(
                f"rc {p.returncode}: {e[-1500:]}" for p, (_, e) in zip(procs, outs)))


def phase_multihost(card, panel):
    """Two processes on the card join a gloo rendezvous on 127.0.0.1 and
    run the 100-gene panel (serial path, device cuda) over their
    round-robin halves; process 0's merged svs.out and VCF must be
    byte-identical to phase 6's serial CUDA output. Then one process runs
    the panel alone, for the wall time beside it. Returns each worker's
    SW launches."""
    from breakmer_tpu_torch.parallel.multihost import partition_targets

    cfg_kwargs, _, work = panel
    runs = {}
    for n in (2, 1):
        out = work / f"multihost_{n}"
        cfg_file = work / f"multihost_{n}.json"
        cfg_file.write_text(json.dumps({**cfg_kwargs, "batch_regions": False, "device": "cuda",
                                        "log_level": "WARNING", "analysis_dir": str(out)}))
        runs[n] = spawn_workers(cfg_file, out, n)
        for name in OUTPUTS:
            check((out / "output" / name).read_bytes()
                  == (work / "cuda" / "output" / name).read_bytes(),
                  f"{n}-process run {name} != the serial CUDA output")
    wall, lines = runs[2]
    names = [f"r{i}" for i in range(lines[0]["of"])]
    for line in lines:
        check(line["targets"] == len(partition_targets(names, line["worker"], 2)),
              f"worker {line['worker']} ran {line['targets']} of {line['of']} targets")
        check(line["sw_launches"] > 0, f"worker {line['worker']}: no SW launch")
    print(f"  multihost 2 processes on {card0()}: targets "
          f"{[line['targets'] for line in lines]} of {lines[0]['of']}, SW launches "
          f"{[line['sw_launches'] for line in lines]}; wall {wall:.2f} s (processes started "
          f"to exit; in-process run {[round(line['run_s'], 2) for line in lines]} s) against "
          f"one process {runs[1][0]:.2f} s ({runs[1][1][0]['run_s']:.2f} s in-process); merged "
          f"svs.out and VCF == serial [{card}]", flush=True)
    return [line["sw_launches"] for line in lines]


def phase_agreement(card):
    """``gpu_agreement`` as a user runs it, with its record; returns its
    SW kernel launches."""
    from breakmer_tpu_torch.ops import sw_cuda
    from breakmer_tpu_torch.tools import gpu_agreement

    out = WORK / "agreement.json"
    sw_cuda.LAUNCHES = 0  # the agreement tool starts here
    rc = gpu_agreement.main(["--out", str(out)])
    launches = sw_cuda.LAUNCHES
    rec = json.loads(out.read_text())
    paths = sum(len(c["paths"]) for c in rec["cases"])
    check(rc == 0 and rec["mismatches"] == 0 and rec["agreement"],
          f"gpu_agreement: {rec['mismatches']} mismatches")
    check(launches == paths, f"gpu_agreement: {launches} SW launches for {paths} paths")
    print(f"  gpu_agreement: {len(rec['cases'])} cases, {paths} paths, 0 mismatches, "
          f"{launches} SW launches on {rec['device']} [{card}]", flush=True)
    return launches


def phase_sweep(card):
    """sweep_accuracy on the repeat-rich genome, on the card and on the
    CPU: the records must be equal apart from wall_s."""
    from breakmer_tpu_torch.ops import sw_cuda
    from breakmer_tpu_torch.tools import sweep_accuracy

    recs = {}
    for device in ("cuda", "cpu"):
        out = WORK / f"sweep_{device}.json"
        sw_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        sweep_accuracy.main(["--genome", "repeats", "--seeds", "8", "--fp", "4",
                             "--device", device, "--out", str(out)])
        wall = time.perf_counter() - t0
        rec = json.loads(out.read_text())
        rec.pop("wall_s")
        recs[device] = rec
        check(device == "cpu" or sw_cuda.LAUNCHES > 0, "the sweep launched no SW kernel")
        print(f"  sweep_accuracy repeats, 8 seeds + 4 FP panels on {device}: {wall:.1f} s, "
              f"SW launches {sw_cuda.LAUNCHES}; recall "
              + ", ".join(f"{k} {v['ok']}/{v['n']}" for k, v in rec["recall"].items())
              + f"; fp calls {rec['fp']['calls']} [{card}]", flush=True)
    check(recs["cuda"] == recs["cpu"], "sweep_accuracy: the card's record != the CPU's")
    print("  sweep_accuracy: the card's record == the CPU's", flush=True)


def phase_fetch_probe():
    from breakmer_tpu_torch.tools import probe_fetch

    probe_fetch.main([])


def phase_genome_e2e(card):
    from breakmer_tpu_torch.tools import bench_genome_e2e

    rec = bench_genome_e2e.main(["100e6"])
    for key in ("ins_called", "del_called", "trl_called", "warm_equals_cold"):
        check(rec[key], f"bench_genome_e2e at 100 Mbp: {key} false")
    print(f"  bench_genome_e2e 100 Mbp on the card: {rec['calls']} calls, cold setup "
          f"{rec['setup_cold_s']} s, warm {rec['setup_warm_s']} s, peak RSS "
          f"{rec['peak_rss_mb']} MB [{card}]", flush=True)


# launches of one entry() step (parallel/step.py): one SW launch over all
# G * B pairs, kmer_codes for the reads and for the references, the
# both-strand table (counted as revcomp_kmers), one each of the others
ENTRY_LAUNCHES = {"sw_wavefront": 1, "kmer_codes": 2, "revcomp_kmers": 1,
                  "unique_counts_sorted": 1, "subtract_sorted": 1, "region_kmers": 0}
DRYRUN_STAGES = ("_dryrun_step", "_dryrun_index", "_dryrun_full_panel")


def zero_launches() -> None:
    from breakmer_tpu_torch.ops import kmer_cuda, sw_cuda

    sw_cuda.LAUNCHES = 0
    sw_cuda.LAUNCHES_BY_FORM.update(ticket=0, block=0)
    for name in kmer_cuda.LAUNCHES:
        kmer_cuda.LAUNCHES[name] = 0


def read_launches() -> dict:
    from breakmer_tpu_torch.ops import kmer_cuda, sw_cuda

    return {"sw_wavefront": sw_cuda.LAUNCHES, **kmer_cuda.LAUNCHES}


def phase_graft_entry(card):
    """The entry points of breakmer_tpu_torch.graft_entry on the card:
    entry()'s step, called with no argument, exact against entry("cpu")'s
    on its example arguments and on tiled reads at its shapes, with
    ENTRY_LAUNCHES a step; ms a step (CUDA events) and device
    ms (queued calls); then dryrun_multichip(4) over [cuda:0] * 4, its
    wall time and each stage's launches (stage 1: one SW launch a shard,
    the k-mer half once a regions block). Returns ({kernel: launches of
    one step}, [{kernel: launches} of each dryrun stage])."""
    from breakmer_tpu_torch import graft_entry
    from breakmer_tpu_torch.parallel.step import to_numpy
    from breakmer_tpu_torch.timing import cuda_ms, queued_ms

    fn, args = graft_entry.entry()
    check(all(a.is_cuda for a in args), "entry(): the example arguments are off the card")
    cpu_fn, cpu_args = graft_entry.entry("cpu")
    (G, R, L), LREF = cpu_args[0].shape, cpu_args[2].shape[1]
    (GB, GLQ), GLT = cpu_args[4].shape[1:], cpu_args[5].shape[2]
    tiled = tuple(torch.from_numpy(a) for a in
                  tiled_region_inputs(G, R, L, LREF, GB, GLQ, GLT))
    step_launches = {}
    for label, host in (("example arguments", cpu_args), ("tiled reads", tiled)):
        on_card = args if host is cpu_args else tuple(a.to(args[0].device) for a in host)
        zero_launches()  # one entry() step starts here
        got = fn(*on_card)
        torch.cuda.synchronize()
        step_launches = read_launches()
        check(step_launches == ENTRY_LAUNCHES,
              f"entry() step ({label}): launches {step_launches}, not {ENTRY_LAUNCHES}")
        got, want = to_numpy(got), to_numpy(cpu_fn(*host))
        check(same_arrays(want, got), f"entry() step ({label}): CUDA != CPU")
        kept = int((got[1] > 0).sum())
        check(label != "tiled reads" or kept > 0, "entry() step on tiled reads: no k-mer kept")
        print(f"  entry() step G={G} R={R} L={L} LREF={LREF} pairs {GB}x{GLQ}x{GLT}, "
              f"{label}: CUDA == CPU ({kept} kept k-mers), launches {step_launches} "
              f"[{card}]", flush=True)
    ms = cuda_ms(lambda: fn(*args))
    dms = queued_ms(lambda: fn(*args))
    print(f"  entry() step: {ms:.4f} ms a step (events), {dms:.4f} ms device (queued) "
          f"[{card}]", flush=True)

    stages, originals = {}, {name: getattr(graft_entry, name) for name in DRYRUN_STAGES}

    def counted(name, stage):
        def run(devs):
            zero_launches()  # this dryrun stage starts here
            t0 = time.perf_counter()
            stage(devs)
            torch.cuda.synchronize()
            stages[name] = (time.perf_counter() - t0, read_launches())
        return run

    try:
        for name, stage in originals.items():
            setattr(graft_entry, name, counted(name, stage))
        t0 = time.perf_counter()
        graft_entry.dryrun_multichip(4, devices=[card0()] * 4)
        wall = time.perf_counter() - t0
    finally:
        for name, stage in originals.items():
            setattr(graft_entry, name, stage)
    check(list(stages) == list(DRYRUN_STAGES), f"dryrun stages run: {list(stages)}")
    want_step = {name: n * (4 if name == "sw_wavefront" else 2)
                 for name, n in ENTRY_LAUNCHES.items()}  # 2x2 mesh: 4 shards, 2 rows
    check(stages["_dryrun_step"][1] == want_step,
          f"dryrun stage 1: launches {stages['_dryrun_step'][1]}, not {want_step}")
    check(all(n > 0 for n in stages["_dryrun_full_panel"][1].values()),
          f"dryrun stage 3: launches {stages['_dryrun_full_panel'][1]}")
    print(f"  dryrun_multichip(4) over [{card0()}] * 4: {wall:.2f} s; "
          + "; ".join(f"stage {i} {s:.2f} s, launches {n}"
                      for i, (s, n) in enumerate(stages.values(), 1))
          + f" [{card}]", flush=True)
    return step_launches, [n for _, n in stages.values()]


def phase_kmer_domain(dev, card):
    """Phase 22: the domain grid through the k-mer kernels against their
    plain versions, then the seed-1 run at k = 0 on the card against the
    CPU. Returns the launches by kernel: of the grid, and of each card
    run."""
    from breakmer_tpu_torch.ops import kmer, kmer_cuda
    from breakmer_tpu_torch.testing import kmer_domain
    from breakmer_tpu_torch.testing.scenarios import build_scenario

    sizes = list(kmer_cuda.cluster_sizes(dev))
    calls = dict.fromkeys(("per_function", "region_kmers"), 0)
    zero_launches()
    for name in kmer_domain.cases():
        try:
            made = kmer_domain.held_on_card(name, dev)
        except AssertionError as exc:
            raise SmokeFailure(f"k-mer domain {name}: card != plain {exc}") from exc
        calls = {key: n + made[key] for key, n in calls.items()}
        if name.startswith(("k=-", "k=0/")) and made["per_function"]:
            check(made["clusters"] == sizes, f"k-mer domain {name}: the region kernel at "
                  f"{made['clusters']}, not at every cluster size {sizes}")
    grid = read_launches()
    print(f"  k-mer domain: {len(kmer_domain.cases())} cases (k {kmer_domain.KS}) exact on the "
          f"card, launches {grid}; region calls on the per-function route {calls['per_function']},"
          f" through the region kernel {calls['region_kmers']} [{card}]", flush=True)

    work = WORK / "k0"
    work.mkdir(parents=True)
    cfg_kwargs, _ = build_scenario(1, work, n_genes=2, kinds=["ins", "del"],
                                   with_normal_germline=True)
    runs = {}
    for mode, batched in (("serial", False), ("batched", True)):
        outs = {}
        for device in ("cpu", "cuda"):
            out = work / f"{mode}_{device}"
            routes = dict(kmer.ROUTES)
            if device == "cuda":
                zero_launches()
            run_panel({**cfg_kwargs, "kmer_size": 0, "seed_kmer_size": 0,
                       "batch_regions": batched}, out, device)
            if device == "cuda":
                runs[mode] = dict(read_launches(),
                                  fused_calls=kmer.ROUTES["fused"] - routes["fused"])
            ledger = json.loads((out / "ledger.json").read_text())
            outs[device] = ([(out / "output" / n).read_bytes() for n in OUTPUTS],
                            {n: (e["rows"], e["vcf"], e["error"]) for n, e in ledger.items()})
        check(outs["cuda"] == outs["cpu"], f"seed 1 at k = 0, {mode}: CUDA != CPU")
        check(len(outs["cuda"][1]) == 3, f"seed 1 at k = 0, {mode}: {len(outs['cuda'][1])} regions")
    check(runs["serial"]["region_kmers"] == runs["serial"]["fused_calls"] > 0,
          f"seed 1 at k = 0, serial: launches {runs['serial']}")
    check(all(runs["batched"][n] > 0 for n in kmer_cuda.KERNELS),
          f"seed 1 at k = 0, batched: launches {runs['batched']}")
    print(f"  seed 1 at k = 0 (2 genes and a germline one): serial and batched byte-identical "
          f"to the CPU, no region error; card launches serial {runs['serial']}, batched "
          f"{runs['batched']} [{card}]", flush=True)
    return {"grid": grid, **runs}


def phase_sw_domain(dev, card):
    """Phase 23: the SW domain grid (signed and large scoring parameters
    crossed with the edges of the shapes and codes, the wide cases too)
    through the kernel at the plan's form, R, pack and no_n and at every R
    forced, packed and unpacked, against the plain version; then seed 1 at
    gap_open_pen = gap_extend_pen = 1,000,000 (the parent refused it on the
    card), serial and batched, on the card against the CPU. Returns the SW
    launches by form: of the grid, and of each card run."""
    from breakmer_tpu_torch.ops import sw_cuda
    from breakmer_tpu_torch.testing import sw_domain
    from breakmer_tpu_torch.testing.scenarios import build_scenario

    names = sw_domain.cases(card=True)
    zero_launches()
    refused = []
    t0 = time.perf_counter()
    for name in names:
        try:
            made = sw_domain.held_on_card(name, dev)
        except AssertionError as exc:
            raise SmokeFailure(f"SW domain {name}: card != plain {exc}") from exc
        if made["refused"]:
            refused.append(name)
    grid = dict(sw_cuda.LAUNCHES_BY_FORM, all=sw_cuda.LAUNCHES)
    check(grid["ticket"] > 0 and grid["block"] > 0, f"SW domain: launches {grid}")
    check(all(n.startswith("score_limit_2^28/") or n.endswith("/lq_0") for n in refused),
          f"SW domain: refused {refused}")
    print(f"  SW domain: {len(names)} cases exact on the card ({len(refused)} refused before "
          f"any launch: the TPU kernel's score limit, Lq = 0), launches {grid}, "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    work = WORK / "ungapped"
    work.mkdir(parents=True)
    cfg_kwargs, _ = build_scenario(1, work, n_genes=2, kinds=["ins", "del"],
                                   with_normal_germline=True)
    runs = {}
    for mode, batched in (("serial", False), ("batched", True)):
        outs = {}
        for device in ("cpu", "cuda"):
            out = work / f"{mode}_{device}"
            zero_launches()
            run_panel({**cfg_kwargs, "gap_open_pen": 1_000_000, "gap_extend_pen": 1_000_000,
                       "batch_regions": batched}, out, device)
            if device == "cuda":
                runs[mode] = dict(sw_cuda.LAUNCHES_BY_FORM, all=sw_cuda.LAUNCHES)
            ledger = json.loads((out / "ledger.json").read_text())
            outs[device] = ([(out / "output" / n).read_bytes() for n in OUTPUTS],
                            {n: (e["rows"], e["vcf"], e["error"]) for n, e in ledger.items()})
        check(outs["cuda"] == outs["cpu"], f"seed 1 ungapped, {mode}: CUDA != CPU")
        check(len(outs["cuda"][1]) == 3, f"seed 1 ungapped, {mode}: {len(outs['cuda'][1])} regions")
        check(runs[mode]["all"] > 0, f"seed 1 ungapped, {mode}: no SW launch")
    print(f"  seed 1 at gap_open_pen = gap_extend_pen = 1,000,000: serial and batched "
          f"byte-identical to the CPU, no region error; SW launches by form serial "
          f"{runs['serial']}, batched {runs['batched']} [{card}]", flush=True)
    return {"grid": grid, **runs}


KERNELS = {  # name: (source, the TPU kernel it replaces)
    "sw_wavefront": ("breakmer_tpu_torch/csrc/sw_wavefront.cu",
                     "breakmer_tpu/ops/sw_pallas.py:179"),
    "sw_ceiling_probe": ("breakmer_tpu_torch/csrc/sw_ceiling_probe.cu",
                         "tools/sw_ceiling_probe.py:43"),
    "probe_i16": ("breakmer_tpu_torch/csrc/probe_i16.cu", "tools/probe_swar_i16.py:39"),
    "probe_i16b": ("breakmer_tpu_torch/csrc/probe_i16.cu", "tools/probe_swar_i16b.py:28"),
    "probe_cummax": ("breakmer_tpu_torch/csrc/probe_cummax.cu",
                     "tools/probe_mosaic_cummax.py:19"),
    **{name: ("breakmer_tpu_torch/csrc/kmer.cu",
              f"{where} (jitted {name}: an XLA program, not a Pallas kernel)")
       for name, where in KMER_KERNELS.items()},
    "region_kmers": ("breakmer_tpu_torch/csrc/region_kmers.cu",
                     "breakmer_tpu/ops/kmer.py:190-235 (sample_only_kmers: a host composite "
                     "of jitted XLA programs, not a Pallas kernel)"),
}


def timed(label, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from breakmer_tpu_torch import _build
    from breakmer_tpu_torch.timing import card_line

    dev = torch.device("cuda")
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {card}", flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    print(f"build: {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    _build.library()

    sw_rows, sw_err, sw_forms = timed("sw", phase_sw, dev, card)
    kmer_rows, kmer_call = timed("kmer", phase_kmer, dev, card)
    timed("slice seeds 1, 7", phase_slice_exact, card)
    panel = build_panel100()
    sw_launches, serial_by_shape, kmer_launches, kmer_routes = timed(
        "panel100", phase_slice_scale, card, panel)
    batched_launches, batched_by_shape, batched_rate, kmer_batched = timed(
        "batched panel100", phase_batched_panel, card, panel, sw_launches)
    timed("kmer batch step", phase_kmer_batch_step, dev, card)
    rows = timed("probe kernels", phase_probes, dev, card)
    timed("region step", phase_region_step, dev, card)
    launches = timed("measurement path", phase_measurement_path)
    step_launches = timed("sharded region step", phase_sharded_region_step, card)
    timed("sharded kmer batch step", phase_sharded_kmer_batch_step, card)
    mesh_launches = timed("mesh runner", phase_mesh_runner, card, panel, batched_rate)
    index_launches = timed("sharded index", phase_sharded_index, card, panel)
    multihost_launches = timed("multihost", phase_multihost, card, panel)
    agreement_launches = timed("gpu_agreement", phase_agreement, card)
    timed("sweep_accuracy cuda vs cpu", phase_sweep, card)
    timed("probe_fetch", phase_fetch_probe)
    timed("bench_genome_e2e 100 Mbp", phase_genome_e2e, card)
    entry_launches, dryrun_launches = timed("graft entry", phase_graft_entry, card)
    domain_launches = timed("kmer domain, k <= 0", phase_kmer_domain, dev, card)
    sw_domain_launches = timed("sw domain", phase_sw_domain, dev, card)

    head = next(r for r in sw_rows if tuple(r["shape"]) == HEADLINE)
    rows["sw_wavefront"] = dict(max_abs_err=sw_err, shape=head["shape"], ms=head["ms"],
                                device_ms=head["device_ms"],
                                profiler_device_ms=head["profiler_device_ms"],
                                plain_ms=head["plain_ms"], library_ms=None,
                                bound=(head["bound_ms"], head["bound_by"]),
                                batched_path_launches=batched_launches,
                                sharded_step_launches=step_launches,
                                mesh_runner_launches=mesh_launches,
                                sharded_index_runner_launches=index_launches,
                                multihost_launches=multihost_launches,
                                agreement_launches=agreement_launches,
                                main_path_by_shape=serial_by_shape,
                                batched_path_by_shape=batched_by_shape,
                                domain_launches=sw_domain_launches, **sw_forms)
    launches["sw_wavefront"] = sw_launches
    for name, row in kmer_rows.items():  # each kernel's path: serial, else batched
        path = "serial" if kmer_launches[name] else "batched"
        rows[name] = dict(row, batched_path_launches=kmer_batched[name], launches_path=path,
                          serial_path_launches=kmer_launches[name])
        launches[name] = kmer_launches[name] or kmer_batched[name]
    rows["region_kmers"]["serial_routes"] = kmer_routes
    for name in ENTRY_LAUNCHES:
        rows[name]["graft_entry_launches"] = {
            "entry_step": entry_launches[name],
            "dryrun_stages": [stage[name] for stage in dryrun_launches]}
    for name in (*KMER_KERNELS, "region_kmers"):
        rows[name]["k_nonpositive_launches"] = {key: n[name]
                                                for key, n in domain_launches.items()}
    rows["kmer_codes"]["sample_only_kmers_call"] = kmer_call
    rows["region_kmers"]["sample_only_kmers_call"] = kmer_call
    table = []
    for name, (source, replaces) in KERNELS.items():
        row = rows[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                      "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
                      "bound_by": row["bound"][1], "library_ms": row["library_ms"],
                      "shape": row["shape"],
                      **{k: row[k] for k in ("op", "device_ms", "profiler_device_ms",
                                             "plain_device_ms", "library_device_ms",
                                             "rolls0_device_ms", "sw_full_device_ms",
                                             "roll_bound_fraction", "library_call_ratio",
                                             "launch_path_us", "warps_device_us",
                                             "bandwidth_shapes",
                                             "batched_path_launches", "sharded_step_launches",
                                             "mesh_runner_launches",
                                             "sharded_index_runner_launches",
                                             "multihost_launches", "agreement_launches",
                                             "graft_entry_launches",
                                             "main_path_by_shape", "batched_path_by_shape",
                                             "form_turns", "step_cycles", "tier_grid",
                                             "contig_device_ms", "bound_share", "batch_step",
                                             "form", "alone", "sample_only_kmers_call",
                                             "launches_path", "serial_path_launches",
                                             "call_ms", "region_cases", "smem_bytes",
                                             "serial_routes", "cluster", "cluster_sizes",
                                             "one_block_device_ms", "phase_clocks",
                                             "held_at", "median_region_call_ms",
                                             "k_nonpositive_launches", "domain_launches")
                         if k in row}})
    print(card_line())
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
