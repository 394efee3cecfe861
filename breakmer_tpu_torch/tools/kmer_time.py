"""Device time of the k-mer engine's functions, and the CUDA kernels one
``sample_only_kmers`` call runs, on the card.

    python /path/to/breakmer_tpu_torch/tools/kmer_time.py [--reps 20] [--call]

Run from the root of a checkout, it times ``kmer_codes``,
``revcomp_kmers``, ``both_strands``, ``unique_counts_sorted`` and
``subtract_sorted`` of the ``breakmer_tpu_torch.ops.kmer`` found there
(the current directory goes first on ``sys.path``), so one copy of this
script times two checkouts alike: run it from each, in turns, within one
session on one card. It uses only those functions and
``sample_only_kmers``, which every checkout of the port has, except
``both_strands``: where a checkout lacks it, its eager form
(``revcomp_kmers`` and a ``torch.cat``) is timed under that name
(``both_strands_form``). Shapes (k = 15): a serial region (a sample of
200 reads of 100 bases, a reference of 1,800, a normal of 160 reads of
102) and the batch step's (32 regions of 512 reads of 128, references of
4,096, a normal of 256 reads), inputs from seed 0; and
``unique_counts_sorted`` at the batch step's shape on sorted rows of runs
of one length each (``RUNS``), which shows how its time follows the
length of the runs it counts.

Each function's device time is the median of 5 windows of 10 calls that
the card runs back to back (it first sleeps while the host queues them),
so the host's launch path is not in it; its host time a call
(``host_us``) is a window of ``reps`` calls on the host clock, the card
waited for at the end. For ``sample_only_kmers`` (host numpy in and out,
so it waits for the card itself): the wall time a call, median of
``reps`` calls, and, from one call under ``torch.profiler``, the CUDA
kernels and the copies it runs, their summed device time, and the
k-mer engine's hand kernels among them by name beside the launches
their wrappers counted in that call (``kmer_cuda.LAUNCHES``). Prints
one JSON line with the times and the card's name and power limit;
``--call`` prints only the ``sample_only_kmers`` reading: the call as
the checkout routes it (since the region kernel, one launch of it where
the plan fuses) and, where the checkout has routes, the per-function
route forced on the same inputs. Where the checkout has the region
kernel, its device time alone (queued launches on staged inputs) is
timed too (``region_kmers serial``). Read it in a fresh process: in one
that has worked on the card for minutes the profiler may drop the first
activities of the window (on an H100 with torch 2.11, 10 of a call's 30
kernels, at random, with or without idle time around the call).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SERIAL = dict(G=0, sample=(200, 100), ref=1800, normal=(160, 102))
BATCH = dict(G=32, sample=(512, 128), ref=4096, normal=(256, 128))
K = 15
RUNS = (1, 2, 4, 13, 64, 1024)  # run lengths of the unique_counts_sorted sweep
# a kernel wrapper's name in kmer_cuda.LAUNCHES: its kernel's symbol in csrc/kmer.cu
SYMBOLS = {"kmer_codes": "kmer_codes_kernel", "revcomp_kmers": "revcomp_kmers_kernel",
           "unique_counts_sorted": "unique_counts_kernel",
           "subtract_sorted": "subtract_sorted_kernel", "region_kmers": "region_kmers_kernel"}
# a serial region's sample_only_kmers inputs (region_case): the name's
# changes to region_inputs' defaults, or the cases built in region_case
REGION_CASES = {
    "serial": {}, "no_normal": dict(normal=None), "k1": dict(k=1), "k11": dict(k=11),
    "min_count_1": dict(min_count=1), "min_count_3": dict(min_count=3),
    "empty_sample": dict(R=0), "all_n": dict(n_rate=1.0), "short_reads": dict(short=True),
    "negative_bytes": dict(neg_rate=0.01), "poly_a": dict(poly_a=True),
    "ref_of_k": dict(ref=K, normal=None), "long_ref": dict(R=20, ref=30_000, min_count=1),
    "odd_widths": dict(R=77, L=37, ref=1001, normal=(13, 29), k=11),
    "staged_in_chunks": dict(R=10, normal=(400, 100), min_count=1), "one_run": dict(same_reads=True),
    "distinct": dict(err=0.3, normal=None), "boundary_fits": dict(boundary=0),
    "boundary_over": dict(boundary=1), "normal_of_short_reads": dict(normal=(50, 20)),
}


def region_inputs(rng, R=200, L=100, ref=1800, normal=(160, 102), k=K, min_count=2,
                  err=0.01, n_rate=0.002, neg_rate=0.0, short=False, poly_a=False,
                  same_reads=False):
    """sample_only_kmers' arguments for one region: R errored reads of L
    bases tiled over a haplotype that carries 300 novel bases against the
    reference (ref bases), a matched normal [Rn, Ln] (None: none) tiled
    over its first half; n_rate of the bytes N (4..127), neg_rate
    negative; ``short``: every read's length below k; ``poly_a``: every
    read all A; ``same_reads``: one read R times. Returns (args, kwargs)."""
    import numpy as np

    hap = rng.integers(0, 4, ref + 300).astype(np.int8)
    reference = np.concatenate([hap[:ref // 2], hap[ref // 2 + 300:]])

    def tile(n, width, hi):
        if n == 0:
            return np.zeros((0, width), np.int8)
        src = np.concatenate([hap, rng.integers(0, 4, width).astype(np.int8)])
        starts = rng.integers(0, max(1, hi - width + 1), n)
        codes = src[starts[:, None] + np.arange(width)]
        wrong = rng.random(codes.shape) < err
        codes[wrong] = rng.integers(0, 4, int(wrong.sum()))
        codes[rng.random(codes.shape) < n_rate] = rng.integers(4, 128)
        neg = rng.random(codes.shape) < neg_rate
        codes[neg] = rng.integers(-128, 0, int(neg.sum()))
        return codes

    codes = tile(R, L, ref + 300)
    if poly_a:
        codes[:] = 0
    if same_reads and R:
        codes[:] = codes[0]
    lengths = (rng.integers(0, k, R) if short else np.full(R, L)).astype(np.int32)
    kw = dict(min_count=min_count)
    if normal is not None:
        kw.update(normal_codes=tile(normal[0], normal[1], ref // 2 + 150),
                  normal_lengths=np.full(normal[0], normal[1], np.int32))
    return (codes, lengths, reference, k), kw


def region_case(name: str, seed: int = 0):
    """REGION_CASES[name]'s arguments (args, kwargs), from ``seed``. The
    boundary cases take the largest sample of 100-base reads (no normal,
    k = 15) whose region kernel fits an H100's block (``boundary=0``), or
    one read more (``boundary=1``): kmer_cuda.region_plan's edge."""
    import numpy as np

    from breakmer_tpu_torch.ops import kmer_cuda

    case = dict(REGION_CASES[name])
    if "boundary" in case:
        over = case.pop("boundary")
        R = 1
        while kmer_cuda.region_plan((R + 1, 100), 1800, None, K,
                                    kmer_cuda.H100_SMEM_OPTIN).route == "fused":
            R += 1
        case.update(R=R + over, normal=None)
    return region_inputs(np.random.default_rng(seed), **case)


def queued_ms(fn, n: int = 10, windows: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        torch.cuda._sleep(int((2 * n * host_s + 2e-3) * 2e9))  # cycles at ~2 GHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def host_us(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def inputs(rng, G, sample, ref, normal):
    """The four functions' arguments on the card for G regions (G = 0:
    one region's unbatched rows), as the engine passes them."""
    import numpy as np
    import torch

    from breakmer_tpu_torch.ops import kmer

    g = max(G, 1)
    (R, L), (Rn, Ln) = sample, normal

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda")

    def reads(n, width):
        codes = rng.integers(0, 4, (g * n, width)).astype(np.int8)
        codes[rng.random(codes.shape) < 0.001] = 4
        return on(codes), on(np.full(g * n, width, np.int32))

    s, s_len = reads(R, L)
    s[: g * R // 2] = s[g * R // 2: g * R // 2 * 2]  # repeated reads: counts > 1
    nr, n_len = reads(Rn, Ln)
    refs = on(rng.integers(0, 4, (g, ref)).astype(np.int8))
    rkm = kmer.kmer_codes(refs, on(np.full(g, ref, np.int32)), K)[0]
    table = torch.sort(torch.cat([rkm, kmer.revcomp_kmers(rkm, K)], -1), -1).values
    lead = (G,) if G else ()
    srt = torch.sort(kmer.kmer_codes(s, s_len, K)[0].reshape(*lead, -1), -1).values
    values, counts, _ = kmer.unique_counts_sorted(srt)
    ntable = torch.sort(kmer.kmer_codes(nr, n_len, K)[0].reshape(*lead, -1), -1).values
    return {"kmer_codes": (s, s_len, K), "revcomp_kmers": (rkm, K), "both_strands": (rkm, K),
            "unique_counts_sorted": (srt,),
            "subtract_sorted": (values, counts, table if G else table[0], ntable)}


def function(kmer, name):
    """The checkout's function ``name``; for ``both_strands`` in a checkout
    without it, its eager form."""
    if name == "both_strands" and not hasattr(kmer, "both_strands"):
        import torch

        return lambda x, k: torch.cat([x, kmer.revcomp_kmers(x, k)], -1)
    return getattr(kmer, name)


def run_rows(rng, r: int):
    """Sorted rows at the batch step's shape [G, R (L - K + 1)] made of runs
    of r copies each (a random phase a row), the last 2 % SENTINEL."""
    import numpy as np
    import torch

    G, (R, L) = BATCH["G"], BATCH["sample"]
    n = R * (L - K + 1)
    rows = (np.arange(n) + rng.integers(0, r, (G, 1))) // r
    rows[:, n - n // 50:] = 0xFFFFFFFF
    return torch.from_numpy(rows.astype(np.int64)).to("cuda")


def call_profile(rng, reps: int, route=None) -> dict:
    """One serial region's sample_only_kmers: the wall ms a call (median
    of ``reps``) and, from one call under the profiler, its CUDA kernels,
    copies and summed device ms, and per hand kernel the activities the
    profiler saw under its symbol beside its wrapper's launches. ``route``
    forces a route ("per_function"); None takes the checkout's own (the
    plan's, where it has one)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from breakmer_tpu_torch.ops import kmer_cuda
    from breakmer_tpu_torch.ops.kmer import sample_only_kmers

    (R, L), (Rn, Ln) = SERIAL["sample"], SERIAL["normal"]
    args = (rng.integers(0, 4, (R, L)).astype(np.int8), np.full(R, L, np.int32),
            rng.integers(0, 4, SERIAL["ref"]).astype(np.int8), K)
    kw = dict(normal_codes=rng.integers(0, 4, (Rn, Ln)).astype(np.int8),
              normal_lengths=np.full(Rn, Ln, np.int32), device="cuda")
    if route is not None:
        kw["route"] = route
    sample_only_kmers(*args, **kw)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sample_only_kmers(*args, **kw)
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    before = dict(kmer_cuda.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sample_only_kmers(*args, **kw)
        torch.cuda.synchronize()
    launches = {n: kmer_cuda.LAUNCHES[n] - before[n] for n in before}
    acts = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
    copies = sum(1 for e in acts if e.name().startswith(("Memcpy", "Memset")))
    seen = {n: sum(1 for e in acts if sym in e.name()) for n, sym in SYMBOLS.items()
            if n in launches}
    return {"wall_ms": statistics.median(walls), "kernels": len(acts) - copies,
            "copies": copies,
            "device_ms": sum(e.end_ns() - e.start_ns() for e in acts) / 1e6,
            "hand_kernels_seen": seen, "hand_kernels_launched": launches,
            "kernel_names": sorted({e.name()[:60] for e in acts})}


def call_profiles(rng, reps: int) -> dict:
    """``call_profile`` of the checkout's own route ("sample_only_kmers")
    and, where the checkout routes by a plan, of the per-function route
    forced ("sample_only_kmers per_function"), on the same inputs."""
    import inspect

    import numpy as np

    from breakmer_tpu_torch.ops.kmer import sample_only_kmers

    seed = int(rng.integers(1 << 31))
    out = {"sample_only_kmers": call_profile(np.random.default_rng(seed), reps)}
    if "route" in inspect.signature(sample_only_kmers).parameters:
        out["sample_only_kmers per_function"] = call_profile(np.random.default_rng(seed), reps,
                                                             route="per_function")
    return out


def region_kernel_ms(case: str = "serial") -> dict:
    """The region kernel alone on a region case's staged inputs: device ms
    of queued launches, the whole call's host µs (its copies and its wait
    included), and the case's shapes."""
    import numpy as np

    from breakmer_tpu_torch.ops import kmer, kmer_cuda

    args, kw = region_case(case)
    segments, total = kmer_cuda.region_pack(args[0], args[1], args[2], kw.get("normal_codes"),
                                            kw.get("normal_lengths"))
    staged = kmer_cuda.region_stage(segments, total, "cuda")
    windows = args[0].shape[0] * (args[0].shape[1] - args[3] + 1)
    return {"shape": {n: list(np.shape(a)) for n, _, a in segments},
            "device_ms": queued_ms(lambda: kmer_cuda.region_run(
                staged, segments, args[3], kw["min_count"], windows)),
            "call_host_us": host_us(lambda: kmer.sample_only_kmers(*args, **kw, device="cuda"),
                                    20)}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--call", action="store_true",
                    help="only the sample_only_kmers call's reading")
    a = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from breakmer_tpu_torch.ops import kmer

    if not torch.cuda.is_available():
        print("kmer_time: no CUDA card", file=sys.stderr)
        return 2
    rng = np.random.default_rng(0)
    if a.call:
        print(json.dumps({**call_profiles(rng, a.reps), "card": card()}))
        return 0
    out = {"tree": os.getcwd(), "functions": {},
           "both_strands_form": ("kernel" if hasattr(kmer, "both_strands")
                                 else "revcomp_kmers + torch.cat")}
    for form, shape in (("serial", SERIAL), ("batch", BATCH)):
        for name, args in inputs(rng, **shape).items():
            fn = function(kmer, name)
            out["functions"][f"{name} {form}"] = {
                "shape": [list(x.shape) for x in args if isinstance(x, torch.Tensor)],
                "device_ms": queued_ms(lambda: fn(*args)),
                "host_us": host_us(lambda: fn(*args), a.reps)}
    for r in RUNS:
        rows = run_rows(rng, r)
        out["functions"][f"unique_counts_sorted runs {r}"] = {
            "shape": list(rows.shape),
            "device_ms": queued_ms(lambda: kmer.unique_counts_sorted(rows)),
            "host_us": host_us(lambda: kmer.unique_counts_sorted(rows), a.reps)}
    from breakmer_tpu_torch.ops import kmer_cuda

    if hasattr(kmer_cuda, "region_run"):
        out["functions"]["region_kmers serial"] = region_kernel_ms()
    out.update(call_profiles(rng, a.reps))
    out["card"] = card()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
