"""Smoke run of the PyTorch/CUDA port (breakmer_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line; each
phase's wall time is printed):
  1. environment: torch, CUDA, the card's name and power limit;
  2. build the CUDA kernels from csrc/ (one nvcc a source, in parallel);
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
     run must have launched the kernel;
  7. the probe kernels against their plain versions on the card, exact:
     the stripped SW loop in both forms at steps 1, 7, 255 and the
     default, every int16 op of both int16 probes, the running max;
  8. the batched panel path on the same 100-gene panel (batch_regions,
     32 regions a packed k-mer launch) on the card, nprocs 1 (cold, then
     warm) and 4: svs.out and the VCF byte-identical to phase 6's serial
     output, no region error, every SW batch launched the kernel;
  9. the k-mer batch step on the card against the CPU, exact, full and
     packed, at 32 regions of 512 reads with a matched normal; both
     timed with their fetch;
 10. the region step on the card against the CPU, exact, at the bench's
     shape;
 11. the measurement path, as a user runs it: python -m
     breakmer_tpu_torch.bench, the ceiling probe and the three probes of
     breakmer_tpu_torch.tools, then python -m
     breakmer_tpu_torch.bench_panel; each probe kernel must have
     launched.
The last two lines are the kernel table and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import shutil
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
OUTPUTS = ("prop_svs.out", "prop.vcf")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


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
    from breakmer_tpu_torch.timing import cuda_ms

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
    return events, metrics, t1 - t0, t2 - t1, runner


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
    from tests.scenarios import build_scenario

    work = WORK / "panel100"
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    cfg_kwargs, checks = build_scenario(5, work, n_genes=100, read_step=2,
                                        with_normal_germline=True, multi_sv_gene=True)
    print(f"  panel built in {time.perf_counter() - t0:.1f} s", flush=True)
    return cfg_kwargs, checks, work


def phase_slice_scale(card, panel):
    from breakmer_tpu.utils.meter import METER
    from breakmer_tpu_torch.ops import sw_cuda

    cfg_kwargs, checks, work = panel
    cfg_kwargs = {**cfg_kwargs, "batch_regions": False}
    sw_cuda.LAUNCHES = 0  # main path starts here
    events, metrics, setup_s, run_s, _ = run_panel(cfg_kwargs, work / "cuda", "cuda")
    launches = sw_cuda.LAUNCHES
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
    torch.cuda.synchronize()
    return launches


def phase_batched_panel(card, panel, serial_sw_batches):
    """The batched path on the 100-gene panel: nprocs 1 cold, nprocs 1
    warm (timed), nprocs 4; each byte-identical to phase 6's serial CUDA
    output. Returns the warm run's SW kernel launches."""
    from breakmer_tpu.utils.meter import METER
    from breakmer_tpu_torch.ops import sw_cuda

    cfg_kwargs, _, work = panel
    serial = {name: (work / "cuda" / "output" / name).read_bytes() for name in OUTPUTS}
    warm_launches = 0
    for label, nprocs in (("cold", 1), ("warm", 1), ("nprocs4", 4)):
        kw = {**cfg_kwargs, "batch_regions": True, "nprocs": nprocs}
        out = work / f"batched_{label}"
        sw_cuda.LAUNCHES = 0  # this run of the batched path starts here
        events, metrics, setup_s, run_s, runner = run_panel(kw, out, "cuda")
        launches = sw_cuda.LAUNCHES
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
            warm_launches = launches
    torch.cuda.synchronize()
    return warm_launches


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


def phase_probes(dev, card):
    """Each probe kernel against its plain version at the probes' shapes:
    (kernel rows for the table, keyed by kernel name)."""
    from breakmer_tpu_torch.timing import cuda_ms
    from breakmer_tpu_torch.tools import probe_mosaic_cummax as cm
    from breakmer_tpu_torch.tools import probe_swar_i16 as i16
    from breakmer_tpu_torch.tools import probe_swar_i16b as i16b
    from breakmer_tpu_torch.tools import sw_ceiling_probe as ceil

    rows = {}
    ceil.check(dev)  # raises on any difference
    q, t = ceil.inputs(dev)
    rows["sw_ceiling_probe"] = dict(
        max_abs_err=0, shape=[ceil.B, ceil.LQ, ceil.LT],
        ms=cuda_ms(lambda: ceil.stripped(q, t, True)),
        plain_ms=cuda_ms(lambda: ceil.stripped_plain(q, t, True)))
    print(f"  ceiling probe: kernel == plain, both forms, steps 1/7/255/"
          f"{ceil.default_steps(ceil.LQ, ceil.LT)}; rolls3 kernel "
          f"{rows['sw_ceiling_probe']['ms']:.4f} ms, plain "
          f"{rows['sw_ceiling_probe']['plain_ms']:.2f} ms [{card}]", flush=True)
    for name, mod in (("probe_i16", i16), ("probe_i16b", i16b)):
        ops = mod.run_ops(mod.OPS, mod.run_op, mod.inputs(), dev)
        bad = [r["name"] for r in ops if not r["exact"]]
        check(not bad, f"{name}: kernel != plain for {bad}")
        mini = next(r for r in ops if r["name"].startswith("fused mini"))
        rows[name] = dict(max_abs_err=max(r["max_abs_err"] for r in ops),
                          shape=list(i16.SHAPE), op=mini["name"],
                          ms=mini["us"] / 1e3, plain_ms=mini["plain_us"] / 1e3,
                          device_ms=mini["device_us"] / 1e3,
                          plain_device_ms=mini["plain_device_us"] / 1e3)
        for r in ops:
            print(f"  {name} {r['name']:32s} exact  kernel {r['us']:.2f} us "
                  f"({r['device_us']:.2f} device)  plain {r['plain_us']:.2f} us "
                  f"({r['plain_device_us']:.2f} device)", flush=True)
    r = cm.measure(dev)
    check(r["exact"], "cummax kernel != plain")
    rows["probe_cummax"] = dict(max_abs_err=r["max_abs_err"], shape=list(cm.SHAPE),
                                ms=r["us"] / 1e3, plain_ms=r["plain_us"] / 1e3,
                                device_ms=r["device_us"] / 1e3,
                                plain_device_ms=r["plain_device_us"] / 1e3)
    print(f"  cummax {cm.SHAPE}: exact; kernel {r['us']:.2f} us "
          f"({r['device_us']:.2f} device), plain {r['plain_us']:.2f} us "
          f"({r['plain_device_us']:.2f} device) [{card}]", flush=True)
    torch.cuda.synchronize()
    return rows


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


KERNELS = {  # name: (source, the TPU kernel it replaces)
    "sw_wavefront": ("breakmer_tpu_torch/csrc/sw_wavefront.cu",
                     "breakmer_tpu/ops/sw_pallas.py:179"),
    "sw_ceiling_probe": ("breakmer_tpu_torch/csrc/sw_ceiling_probe.cu",
                         "tools/sw_ceiling_probe.py:43"),
    "probe_i16": ("breakmer_tpu_torch/csrc/probe_i16.cu", "tools/probe_swar_i16.py:39"),
    "probe_i16b": ("breakmer_tpu_torch/csrc/probe_i16.cu", "tools/probe_swar_i16b.py:28"),
    "probe_cummax": ("breakmer_tpu_torch/csrc/probe_cummax.cu",
                     "tools/probe_mosaic_cummax.py:19"),
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
    timed("kmer", phase_kmer, dev, card)
    timed("slice seeds 1, 7", phase_slice_exact, card)
    panel = build_panel100()
    sw_launches = timed("panel100", phase_slice_scale, card, panel)
    batched_launches = timed("batched panel100", phase_batched_panel, card, panel,
                             sw_launches)
    timed("kmer batch step", phase_kmer_batch_step, dev, card)
    rows = timed("probe kernels", phase_probes, dev, card)
    timed("region step", phase_region_step, dev, card)
    launches = timed("measurement path", phase_measurement_path)

    head = next(r for r in sw_rows if tuple(r["shape"]) == HEADLINE)
    rows["sw_wavefront"] = dict(max_abs_err=sw_err, shape=head["shape"], ms=head["ms"],
                                plain_ms=head["plain_ms"],
                                batched_path_launches=batched_launches)
    launches["sw_wavefront"] = sw_launches
    table = []
    for name, (source, replaces) in KERNELS.items():
        row = rows[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                      "plain_ms": row["plain_ms"], "shape": row["shape"],
                      **{k: row[k] for k in ("op", "device_ms", "plain_device_ms",
                                             "batched_path_launches") if k in row}})
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
