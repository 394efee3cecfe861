"""Smoke run of the PyTorch/CUDA port (breakmer_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. environment: torch, CUDA, the card's name and power limit;
  2. build the CUDA kernels from csrc/ (timed);
  3. the SW kernel against the plain torch version on the card, bit-exact
     at the shapes realign produces, with no_n off and on, ~1% N and
     custom scoring; median of 5 CUDA-event timings of each;
  4. the k-mer engine on the card against the CPU (2,000 x 150 bp reads,
     3 kb region, matched normal);
  5. the serial slice on the card (python -m breakmer_tpu_torch.cli run,
     driven as the CLI drives it) on scenario seeds 1 and 7: every
     planted-SV checker must pass;
  6. the slice at panel scale: a 100-gene errored panel with a matched
     normal, on the card and then on the CPU; svs.out and the VCF must be
     byte-identical, no region may fail, and every SW batch of the card
     run must have launched the kernel.
The last two lines are the kernel table and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
SW_SHAPES = [(512, 256, 512), (301, 128, 256), (37, 1024, 2048), (16, 1024, 6144),
             (8, 3072, 2048), (64, 512, 16384), (2, 10240, 2048)]
HEADLINE = (512, 256, 512)
CI_KINDS = {1: ["ins", "del", "dup", None], 7: ["inv", "trl", None, None]}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of fn() (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def phase_sw(dev, card):
    from breakmer_tpu_torch.ops import sw_cuda
    from breakmer_tpu_torch.ops.sw import SWParams, sw_score

    rng = np.random.default_rng(2024)
    max_err = 0
    rows = []
    for B, Lq, Lt in SW_SHAPES:
        cases = [("planted", 0.0, SWParams(), (False, True)),
                 ("1% N", 0.01, SWParams(), (False,)),
                 ("params 3,2,4,2", 0.0, SWParams(3, 2, 4, 2), (False, True))]
        for label, n_rate, params, no_n_forms in cases:
            q, t = (torch.from_numpy(a).to(dev) for a in sw_inputs(rng, B, Lq, Lt, n_rate))
            ref = sw_score(q, t, params)
            for no_n in no_n_forms:
                got = sw_cuda.sw_score_cuda(q, t, params, no_n=no_n)
                torch.cuda.synchronize()
                err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(ref, got))
                max_err = max(max_err, err)
                check(err == 0, f"SW kernel != plain at {(B, Lq, Lt)} {label} no_n={no_n}")
        q, t = (torch.from_numpy(a).to(dev) for a in sw_inputs(rng, B, Lq, Lt))
        k_ms = cuda_ms(lambda: sw_cuda.sw_score_cuda(q, t, no_n=True))
        p_ms = cuda_ms(lambda: sw_score(q, t))
        cells = B * Lq * Lt
        rows.append(dict(shape=[B, Lq, Lt], ms=k_ms, plain_ms=p_ms,
                         gcups=cells / k_ms / 1e6, plain_gcups=cells / p_ms / 1e6))
        print(f"  SW {B}x{Lq}x{Lt}: exact; kernel {k_ms:.4f} ms "
              f"({cells / k_ms / 1e6:.2f} GCUPS), plain {p_ms:.2f} ms "
              f"({cells / p_ms / 1e6:.4f} GCUPS) [{card}]", flush=True)
    torch.cuda.synchronize()
    return rows, max_err


def phase_kmer(dev, card):
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


def run_panel(cfg_kwargs, out: Path, device: str):
    """Drive the port as ``python -m breakmer_tpu_torch.cli run`` does."""
    from breakmer_tpu.config import Config
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
    return events, metrics, t1 - t0, t2 - t1


def checker_results(checks, events):
    res = {}
    for gene, (kind, chk) in checks.items():
        evs = [e for e in events if e.genes.split(",")[0] == gene]
        res[gene] = (kind, chk(evs))
    return res


def phase_slice_exact(card):
    from tests.scenarios import build_scenario

    for seed, kinds in CI_KINDS.items():
        work = WORK / f"seed{seed}"
        work.mkdir(parents=True)
        cfg_kwargs, checks = build_scenario(seed, work, n_genes=4, kinds=kinds,
                                            with_normal_germline=True, multi_sv_gene=True)
        cfg_kwargs["batch_regions"] = False
        events, _, _, run_s = run_panel(cfg_kwargs, work / "cuda", "cuda")
        fails = [f"{g} ({k}): {f}" for g, (k, fs) in checker_results(checks, events).items()
                 for f in fs]
        check(not fails, f"seed {seed} on CUDA: " + "; ".join(fails))
        print(f"  slice seed {seed}: {len(checks)} checkers pass on CUDA "
              f"({len(events)} calls, {run_s:.2f} s) [{card}]", flush=True)
    torch.cuda.synchronize()


def phase_slice_scale(card):
    from breakmer_tpu.utils.meter import METER
    from breakmer_tpu_torch.ops import sw_cuda
    from tests.scenarios import build_scenario

    work = WORK / "panel100"
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    cfg_kwargs, checks = build_scenario(5, work, n_genes=100, read_step=2,
                                        with_normal_germline=True, multi_sv_gene=True)
    cfg_kwargs["batch_regions"] = False
    print(f"  panel built in {time.perf_counter() - t0:.1f} s", flush=True)

    sw_cuda.LAUNCHES = 0  # main path starts here
    events, metrics, setup_s, run_s = run_panel(cfg_kwargs, work / "cuda", "cuda")
    launches = sw_cuda.LAUNCHES
    sw_batches = METER.sw_launches
    check(launches > 0, "main path launched the SW kernel no time")
    check(launches == sw_batches,
          f"SW kernel launches {launches} != sw_score_batch calls {sw_batches}")
    cpu_events, cpu_metrics, _, cpu_s = run_panel(cfg_kwargs, work / "cpu", "cpu")
    for name in ("prop_svs.out", "prop.vcf"):
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
    torch.cuda.synchronize()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from breakmer_tpu_torch import _build

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

    rows, max_err = phase_sw(dev, card)
    phase_kmer(dev, card)
    phase_slice_exact(card)
    launches = phase_slice_scale(card)

    head = next(r for r in rows if tuple(r["shape"]) == HEADLINE)
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "sw_wavefront", "route": "cuda",
        "source": "breakmer_tpu_torch/csrc/sw_wavefront.cu",
        "replaces": "breakmer_tpu/ops/sw_pallas.py:179",
        "launches": launches, "max_abs_err": max_err,
        "ms": head["ms"], "plain_ms": head["plain_ms"], "shape": head["shape"],
    }]}))
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
