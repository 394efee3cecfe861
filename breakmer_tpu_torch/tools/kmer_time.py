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
``--call`` prints only the ``sample_only_kmers`` reading. Read it in a
fresh process: in one that has worked on the card for minutes the
profiler may drop the first activities of the window (on an H100 with
torch 2.11, 10 of a call's 30 kernels, at random, with or without idle
time around the call).
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
           "subtract_sorted": "subtract_sorted_kernel"}


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


def call_profile(rng, reps: int) -> dict:
    """One serial region's sample_only_kmers: the wall ms a call (median
    of ``reps``) and, from one call under the profiler, its CUDA kernels,
    copies and summed device ms, and per hand kernel the activities the
    profiler saw under its symbol beside its wrapper's launches."""
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
    seen = {n: sum(1 for e in acts if sym in e.name()) for n, sym in SYMBOLS.items()}
    return {"wall_ms": statistics.median(walls), "kernels": len(acts) - copies,
            "copies": copies,
            "device_ms": sum(e.end_ns() - e.start_ns() for e in acts) / 1e6,
            "hand_kernels_seen": seen, "hand_kernels_launched": launches,
            "kernel_names": sorted({e.name()[:60] for e in acts})}


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
        print(json.dumps({"sample_only_kmers": call_profile(rng, a.reps), "card": card()}))
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
    out["sample_only_kmers"] = call_profile(rng, a.reps)
    out["card"] = card()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
