"""Smoke run of the PyTorch/CUDA port (breakmer_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line; each
phase's wall time is printed):
  1. environment: torch, CUDA, the card's name and power limit;
  2. build the CUDA kernels from csrc/ (one nvcc a source, in parallel);
  3. the SW kernel against the plain torch version on the card, bit-exact
     at the shapes realign produces, with no_n off and on, ~1% N and
     custom scoring (one set past the packed row key's range), at the
     launch plan's rows a lane and at each one forced, packed and
     unpacked; median of 5 CUDA-event timings of each, with GCUPS, the
     bound and the share of it the kernel reaches;
  4. the k-mer engine on the card against the CPU (2,000 x 150 bp reads,
     3 kb region, matched normal); then each of the four k-mer kernels
     (csrc/kmer.cu) against its plain version, exact, at a serial
     region's shapes and the batch step's, with its device time (queued
     calls), a call's time, the plain version's, the bound and one torch
     call's where one computes the same function; and the CUDA kernels
     one sample_only_kmers call runs (profiler);
  5. the serial slice on the card (python -m breakmer_tpu_torch.cli run,
     driven as the CLI drives it) on scenario seeds 1 and 7: every
     planted-SV checker must pass;
  6. the slice at panel scale: a 100-gene errored panel with a matched
     normal, on the card and then on the CPU; svs.out and the VCF must be
     byte-identical, no region may fail, every SW batch of the card run
     must have launched the kernel, every k-mer kernel must have
     launched, kmer_codes at least twice a region that reached the k-mer
     stage (three times with a normal); a second card run records the SW
     launches by shape, each replayed for its kernel time beside its
     bound (the timed run records nothing);
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
     k-mer kernel launched; then a
     recorded warm run gives the SW launches by shape as in phase 6;
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
 14. the batched runner on the 100-gene panel with
     ``device.local_devices`` patched to [cuda:0] * 4 (its k-mer launches
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
     form): 0 mismatches, one SW launch a case, path and form;
 18. sweep_accuracy --genome repeats --seeds 8 --fp 4 on the card and on
     the CPU: the two records equal apart from wall_s;
 19. probe_fetch: one fetch of n buffers against n fetches, pageable and
     pinned; its JSON line;
 20. bench_genome_e2e at 100 Mbp on the card: ins, del and trl called,
     the warm run (index artifact reloaded) equal to the cold one.
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

import contextlib
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
    for B, Lq, Lt in SW_SHAPES:
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
        for R in sw_cuda.ROWS_PER_LANE:
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
        p_ms = cuda_ms(lambda: sw_score(q, t))
        if (B, Lq, Lt) == HEADLINE:  # the profiler's reading of a ctypes launch
            prof_ms = device_us(lambda: sw_cuda.sw_score_cuda(q, t, no_n=True), n=20) / 1e3
            print(f"  SW {B}x{Lq}x{Lt}: device ms, torch.profiler (timing.device_us) "
                  f"{prof_ms:.4f}, queued events {d_ms:.4f} [{card}]", flush=True)
        cells = B * Lq * Lt
        b_ms, b_by = sw_bound(B, Lq, Lt)
        rows.append(dict(shape=[B, Lq, Lt], ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                         profiler_device_ms=prof_ms if (B, Lq, Lt) == HEADLINE else None,
                         bound_ms=b_ms, bound_by=b_by, rows_per_lane=plan.rows_per_lane,
                         strips=plan.strips, device_ms_by_rows_per_lane=by_r,
                         gcups=cells / k_ms / 1e6, plain_gcups=cells / p_ms / 1e6))
        print(f"  SW {B}x{Lq}x{Lt}: exact; kernel {k_ms:.4f} ms a call, {d_ms:.4f} ms "
              f"on the device ({cells / k_ms / 1e6:.2f} GCUPS a call; R={plan.rows_per_lane}, "
              f"{plan.strips} strips, {plan.warps} warps), bound {b_ms:.4f} ms "
              f"({b_by}), {b_ms / d_ms:.1%} of the bound on the device; device ms by R "
              + ", ".join(f"{R}: {ms:.4f}" for R, ms in by_r.items())
              + f"; plain {p_ms:.2f} ms ({cells / p_ms / 1e6:.4f} GCUPS) [{card}]",
              flush=True)
    sw_step_costs(dev, card)
    torch.cuda.synchronize()
    return rows, max_err


def sw_step_costs(dev, card):
    """The table behind ops/sw_cuda.py's STEP_CYCLES (the lag included):
    clocks a step of one strip of 32 R x 4096 with 1, 2 and 4 warps a SM
    partition, and the steps one pair of 8 strips over 2048 columns takes
    past one strip, a strip (device time of queued launches)."""
    from breakmer_tpu_torch.ops import sw_cuda
    from breakmer_tpu_torch.timing import queued_ms

    rng = np.random.default_rng(5)
    hz = _PEAK["mhz"] * 1e6
    codes = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.integers(0, 4, shape).astype(np.int8)).to(dev)
    for R in sw_cuda.ROWS_PER_LANE:
        cells = []
        for w in (1, 2, 4):
            B, Lt = 4 * _PEAK["sms"] * w, 4096
            q, t = codes(B, 32 * R), codes(B, Lt)
            ms = queued_ms(lambda: sw_cuda.sw_score_cuda(q, t, no_n=True, rows_per_lane=R), 5)
            cells.append(f"{w}/partition {ms * 1e-3 * hz / (Lt + 31) / w:.0f}")
        steps = {}
        for S in (1, 8):
            q, t = codes(1, 32 * R * S), codes(1, 2048)
            ms = queued_ms(lambda: sw_cuda.sw_score_cuda(q, t, no_n=True, rows_per_lane=R), 5)
            steps[S] = ms * 1e-3 * hz
        lag = (steps[8] / steps[1] - 1) * (2048 + 31) / 7
        print(f"  SW step clocks a warp, R={R}: " + ", ".join(cells)
              + f"; strip lag {lag:.0f} steps [{card}]", flush=True)


class SWRecorder:
    """While open, records the inputs of every ``sw_score_cuda`` call (the
    main path's SW launches; the wrapper still counts its own launches);
    ``by_shape`` then replays each call for its device time (queued CUDA
    events, ``timing.queued_ms``), summed by (B, Lq, Lt)."""

    def __enter__(self):
        from breakmer_tpu_torch.ops import sw_cuda

        self.mod, self.orig, self.calls = sw_cuda, sw_cuda.sw_score_cuda, []

        def record(q, t, *args, **kwargs):
            self.calls.append((q.clone(), t.clone(), args, kwargs))
            return self.orig(q, t, *args, **kwargs)

        sw_cuda.sw_score_cuda = record
        return self

    def __exit__(self, *exc):
        self.mod.sw_score_cuda = self.orig

    def by_shape(self, label, card):
        from breakmer_tpu_torch.timing import queued_ms

        before = self.mod.LAUNCHES
        out = {}
        for q, t, args, kwargs in self.calls:
            shape = (q.shape[0], q.shape[1], t.shape[1])
            row = out.setdefault(shape, dict(launches=0, ms=0.0, bound_ms=0.0))
            row["launches"] += 1
            row["ms"] += queued_ms(lambda: self.orig(q, t, *args, **kwargs), n=3)
            row["bound_ms"] += sw_bound(*shape)[0]
        self.mod.LAUNCHES = before  # replays are no launches of the main path
        for (B, Lq, Lt), r in sorted(out.items()):
            print(f"  {label} SW launches {B}x{Lq}x{Lt}: {r['launches']}, kernel "
                  f"{r['ms']:.4f} ms summed, bound {r['bound_ms']:.4f} ms, launches x "
                  f"(time - bound) {r['ms'] - r['bound_ms']:.4f} ms [{card}]", flush=True)
        return [dict(shape=list(k), **v) for k, v in sorted(out.items())]


# A contig window of the germline recheck; the k-mer kernels' other shapes
# are tools/kmer_time.py's SERIAL (a region of the serial path) and BATCH
# (phase 9's batch step)
KMER_CONTIG = 60
KMER_KERNELS = {  # name: the jitted JAX function (an XLA program, no Pallas kernel)
    "kmer_codes": "breakmer_tpu/ops/kmer.py:43-44",
    "revcomp_kmers": "breakmer_tpu/ops/kmer.py:102-103",
    "unique_counts_sorted": "breakmer_tpu/ops/kmer.py:121-122",
    "subtract_sorted": "breakmer_tpu/ops/kmer.py:162-163",
}


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
            "unique_counts_sorted": (srt,), "subtract_sorted": (values, counts, table, ntable)}


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


def kmer_kernel_rows(dev, card):
    """Each k-mer kernel against its plain version on the card, exact, at
    the serial path's and the batch step's shapes, with its device time
    (queued calls), a call's time (events), the plain version's, the
    bound and the library call's; then the CUDA kernels one
    sample_only_kmers call runs (profiler). Returns (kernel rows for
    the table, keyed by name; the kernels a call)."""
    from breakmer_tpu_torch.ops import kmer, kmer_cuda
    from breakmer_tpu_torch.timing import cuda_ms, queued_ms
    from breakmer_tpu_torch.tools import kmer_time

    rng = np.random.default_rng(9)
    forms = {"serial": kmer_kernel_inputs(rng, dev, **kmer_time.SERIAL),
             "batch": kmer_kernel_inputs(rng, dev, **kmer_time.BATCH)}
    rows = {}
    for form, inputs in forms.items():
        for name, args in inputs.items():
            kernel, plain = getattr(kmer, name), getattr(kmer, f"{name}_plain")
            before = kmer_cuda.LAUNCHES[name]
            got = kernel(*args)
            torch.cuda.synchronize()
            check(kmer_cuda.LAUNCHES[name] == before + 1, f"{name}: no launch of its kernel")
            got = got if isinstance(got, tuple) else (got,)
            want = plain(*args)
            want = want if isinstance(want, tuple) else (want,)
            check(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(want, got)),
                  f"{name} ({form}): kernel != plain")
            lib = kmer_library(name, args)
            r = dict(shape=[list(a.shape) for a in args if isinstance(a, torch.Tensor)],
                     max_abs_err=0, ms=cuda_ms(lambda: kernel(*args)),
                     device_ms=queued_ms(lambda: kernel(*args)),
                     plain_ms=cuda_ms(lambda: plain(*args)),
                     plain_device_ms=queued_ms(lambda: plain(*args)),
                     library_ms=None if lib is None else cuda_ms(lib),
                     library_device_ms=None if lib is None else queued_ms(lib),
                     bound=kmer_bound(args, got))
            if name == "kmer_codes" and form == "serial":  # a contig window too
                row = args[0][:1, :KMER_CONTIG].contiguous()
                one = torch.tensor([KMER_CONTIG], dtype=torch.int32, device=dev)
                check(all(torch.equal(a, b) for a, b in zip(
                    kmer.kmer_codes_plain(row, one, 15), kmer.kmer_codes(row, one, 15))),
                    "kmer_codes (contig window): kernel != plain")
                r["contig_device_ms"] = queued_ms(lambda: kmer.kmer_codes(row, one, 15))
            lib_txt = "none" if lib is None else (
                f"{r['library_ms']:.4f} ({r['library_device_ms']:.4f} device)")
            print(f"  {name} {form} {r['shape']}: kernel == plain; device "
                  f"{r['device_ms']:.4f} ms (queued), a call {r['ms']:.4f} ms; plain "
                  f"{r['plain_ms']:.4f} ({r['plain_device_ms']:.4f} device); bound "
                  f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); library {lib_txt} ms [{card}]",
                  flush=True)
            if form == "serial":
                rows[name] = r
            else:
                rows[name]["batch_step"] = {k: v for k, v in r.items() if k != "max_abs_err"}
    call = kmer_time.call_profile(rng, reps=5)
    print(f"  sample_only_kmers {kmer_time.SERIAL}: {call['kernels']} CUDA kernels and "
          f"{call['copies']} copies a call (profiler), {call['device_ms']:.4f} ms of device "
          f"time, {call['wall_ms']:.4f} ms a call [{card}]", flush=True)
    return rows, {k: call[k] for k in ("kernels", "copies", "device_ms", "wall_ms")}


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
    t0 = time.perf_counter()
    sample_only_kmers(*args, **kw, device=dev)
    ms = (time.perf_counter() - t0) * 1e3
    print(f"  kmer: CUDA == CPU, {len(got[0])} sample-only k-mers; "
          f"{ms:.2f} ms a call on the card (host clock) [{card}]", flush=True)
    return kmer_kernel_rows(dev, card)


class KmerCalls:
    """Counts the serial path's sample_only_kmers calls (those with a
    matched normal apart) while it is entered, and sets every k-mer
    kernel's launch count to 0 on entry; ``launches`` holds the counts
    on exit."""

    def __enter__(self):
        from breakmer_tpu_torch import pipeline
        from breakmer_tpu_torch.ops import kmer_cuda

        self.pipeline, self.kmer_cuda = pipeline, kmer_cuda
        self.orig = pipeline.sample_only_kmers
        self.calls = self.with_normal = 0
        self.shapes = []  # (sample reads, read length, reference length) a call

        def counted(*args, normal_codes=None, **kw):
            self.calls += 1
            self.with_normal += normal_codes is not None
            self.shapes.append((*args[0].shape, len(args[2])))
            return self.orig(*args, normal_codes=normal_codes, **kw)

        pipeline.sample_only_kmers = counted
        for name in kmer_cuda.KERNELS:
            kmer_cuda.LAUNCHES[name] = 0
        return self

    def __exit__(self, *exc):
        self.launches = dict(self.kmer_cuda.LAUNCHES)
        self.pipeline.sample_only_kmers = self.orig

    def check(self, label: str, serial: bool) -> dict:
        """Every k-mer kernel launched; on the serial path, kmer_codes at
        least twice a region that reached the k-mer stage (three times
        with a normal)."""
        for name, n in self.launches.items():
            check(n > 0, f"{label}: the {name} kernel launched no time")
        if serial:
            need = 2 * self.calls + self.with_normal
            check(self.launches["kmer_codes"] >= need,
                  f"{label}: {self.launches['kmer_codes']} kmer_codes launches for "
                  f"{self.calls} regions ({self.with_normal} with a normal): want >= {need}")
        med = np.median(np.array(self.shapes), axis=0).tolist() if self.shapes else None
        print(f"  {label} k-mer kernel launches {self.launches} ({self.calls} regions "
              f"reached the k-mer stage, {self.with_normal} with a normal; median sample "
              f"reads, read length, reference length {med})", flush=True)
        return self.launches


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
    with KmerCalls() as kmer_calls:  # every k-mer kernel's count is 0 here
        sw_cuda.LAUNCHES = 0  # main path starts here
        events, metrics, setup_s, run_s, _ = run_panel(cfg_kwargs, work / "cuda", "cuda")
        launches = sw_cuda.LAUNCHES
    kmer_launches = kmer_calls.check("panel100 serial", serial=True)
    sw_batches = METER.sw_launches
    check(launches > 0, "main path launched the SW kernel no time")
    check(launches == sw_batches,
          f"SW kernel launches {launches} != sw_score_batch calls {sw_batches}")
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
    check(len(rec.calls) == launches, "the recorded serial run launched SW differently")
    by_shape = rec.by_shape("panel100 serial", card)
    torch.cuda.synchronize()
    return launches, by_shape, kmer_launches


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
    warm_launches, warm_rate, kmer_launches = 0, 0.0, {}
    for label, nprocs in (("cold", 1), ("warm", 1), ("nprocs4", 4)):
        kw = {**cfg_kwargs, "batch_regions": True, "nprocs": nprocs}
        out = work / f"batched_{label}"
        with KmerCalls() as kmer_calls:
            sw_cuda.LAUNCHES = 0  # this run of the batched path starts here
            events, metrics, setup_s, run_s, runner = run_panel(kw, out, "cuda")
            launches = sw_cuda.LAUNCHES
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
              f"(serial run: {serial_sw_batches}), {metrics['sw']['cells']} cells; "
              f"svs.out and VCF == serial [{card}]", flush=True)
        if label == "warm":
            warm_launches, warm_rate = launches, n_regions / run_s
            kmer_launches = kmer_calls.launches
    kw = {**cfg_kwargs, "batch_regions": True, "nprocs": 1}
    with SWRecorder() as rec:  # an untimed warm run for the launches by shape
        run_panel(kw, work / "batched_recorded", "cuda")
    check(len(rec.calls) == warm_launches, "the recorded batched run launched SW differently")
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


@contextlib.contextmanager
def local_devices(devices):
    """``device.local_devices`` patched to ``devices`` (a virtual mesh:
    the runner's only source of its devices), restored afterwards."""
    from breakmer_tpu_torch import device

    orig = device.local_devices
    device.local_devices = lambda _device="auto": list(devices)
    try:
        yield
    finally:
        device.local_devices = orig


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
    """The batched runner on the 100-gene panel with ``local_devices`` at
    [cuda:0] * 4: its k-mer launches go through a (2, 2) mesh. Twice
    (the second run timed as warm); svs.out and the VCF byte-identical to
    phase 6's serial CUDA output. Returns the warm run's SW launches."""
    from breakmer_tpu_torch.ops import sw_cuda
    from breakmer_tpu_torch.utils.meter import METER

    cfg_kwargs, _, work = panel
    serial = {name: (work / "cuda" / "output" / name).read_bytes() for name in OUTPUTS}
    kw = {**cfg_kwargs, "batch_regions": True, "nprocs": 1}
    launches = 0
    for label in ("first", "warm"):
        out = work / f"mesh_{label}"
        sw_cuda.LAUNCHES = 0  # this run of the mesh runner starts here
        with local_devices([card0()] * 4):
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
    with local_devices([dev] * 4):
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

    sw_rows, sw_err = timed("sw", phase_sw, dev, card)
    kmer_rows, kmer_call = timed("kmer", phase_kmer, dev, card)
    timed("slice seeds 1, 7", phase_slice_exact, card)
    panel = build_panel100()
    sw_launches, serial_by_shape, kmer_launches = timed(
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
                                batched_path_by_shape=batched_by_shape)
    launches["sw_wavefront"] = sw_launches
    for name, row in kmer_rows.items():
        rows[name] = dict(row, batched_path_launches=kmer_batched[name])
        launches[name] = kmer_launches[name]
    rows["kmer_codes"]["sample_only_kmers_call"] = kmer_call
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
                                             "main_path_by_shape", "batched_path_by_shape",
                                             "contig_device_ms", "batch_step",
                                             "sample_only_kmers_call")
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
