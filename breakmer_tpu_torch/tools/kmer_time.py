"""Device time of the k-mer engine's functions, and the CUDA kernels one
``sample_only_kmers`` call runs, on the card.

    python /path/to/breakmer_tpu_torch/tools/kmer_time.py [--reps 20] [--call]
        [--region] [--sweep] [--panel] [--routes] [--cluster C]

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

The region kernel's own readings, each printed alone as one JSON line:
``--region`` times it at the serial shape and at the 100-gene panel's
median region (47 reads of 101) at each cluster size the card runs and
at the plan's, with a call's host µs, and reads its phase clocks (the
kernel's clock64 stamps); ``--sweep`` times it at each cluster size over
samples of 5 to 2,400 reads of 100 bases; ``--panel`` runs chip_smoke.py's
100-gene panel serially on the card once and launches every region the
plan fuses back to back between two CUDA events; ``--routes`` runs
``tools/bench_panel_scaling``'s two deep tiers at 100 genes serially and
counts their routes (``kmer.ROUTES``). ``--cluster C`` forces the
kernel's cluster size in ``--region`` and in the default reading. All
but ``--sweep`` and the clocks also run on a checkout of one block.
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
    "old_limit_fits": dict(R=308, normal=None), "old_limit_over": dict(R=309, normal=None),
    "past_old_limit": dict(R=600), "deep_250": dict(R=340, L=250, normal=None),
    "mostly_poly_a": dict(heavy=0.9), "tandem": dict(tandem=True),
    "k0": dict(k=0), "k_minus_1": dict(k=-1),
}


def region_inputs(rng, R=200, L=100, ref=1800, normal=(160, 102), k=K, min_count=2,
                  err=0.01, n_rate=0.002, neg_rate=0.0, short=False, poly_a=False,
                  same_reads=False, heavy=0.0, tandem=False):
    """sample_only_kmers' arguments for one region: R errored reads of L
    bases tiled over a haplotype that carries 300 novel bases against the
    reference (ref bases), a matched normal [Rn, Ln] (None: none) tiled
    over its first half; n_rate of the bytes N (4..127), neg_rate
    negative; ``short``: every read's length below k; ``poly_a``: every
    read all A; ``heavy``: that share of the reads all A (one value holds
    most windows); ``tandem``: every read a CA repeat, errored (two
    values hold most windows); ``same_reads``: one read R times. Returns
    (args, kwargs)."""
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
    codes[:int(heavy * R)] = 0
    if tandem:
        codes[:] = np.arange(L) % 2
        wrong = rng.random(codes.shape) < err
        codes[wrong] = rng.integers(0, 4, int(wrong.sum()))
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
    k = 15) whose region kernel fits an H100 at a cluster size it runs
    (``boundary=0``), or one read more (``boundary=1``):
    kmer_cuda.region_plan's edge. The old limit's cases are the edge of
    one block of the first design (308 reads of 100 bases)."""
    import numpy as np

    from breakmer_tpu_torch.ops import kmer_cuda

    case = dict(REGION_CASES[name])
    if "boundary" in case:
        over = case.pop("boundary")
        R, step = 1, 1024
        while step:  # the last R that fuses (the route turns once, as R grows)
            if kmer_cuda.region_plan((R + step, 100), 1800, None, K,
                                     kmer_cuda.H100_SMEM_OPTIN).route == "fused":
                R += step
            else:
                step //= 2
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


def call_us(fn, reps: int = 100) -> float:
    """The median host µs of single calls of ``fn`` (which waits for the
    card itself), after a warm call."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(walls)


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


def plan_of(args, kw, cluster=None):
    """The checkout's card plan of a region's inputs (a checkout without
    cluster sizes: its plan against the card's shared memory), and the
    cluster size it launches at (1 there)."""
    import numpy as np

    from breakmer_tpu_torch.ops import kmer_cuda

    normal = kw.get("normal_codes")
    shapes = (np.shape(args[0]), len(args[2]), None if normal is None else np.shape(normal),
              args[3])
    if hasattr(kmer_cuda, "card_plan"):
        plan = kmer_cuda.card_plan(*shapes, "cuda", cluster)
        return plan, plan.cluster
    return kmer_cuda.region_plan(*shapes, kmer_cuda.smem_optin("cuda")), 1


def region_launcher(args, kw, cluster=None, clocks=None):
    """A function that launches the region kernel once on the region's
    inputs, staged on the card beforehand, at the plan's cluster size or
    ``cluster``; and that size (None: the plan does not fuse)."""
    import torch

    from breakmer_tpu_torch.ops import kmer_cuda

    plan, C = plan_of(args, kw, cluster)
    if plan.route != "fused":
        return None, None
    segments, total = kmer_cuda.region_pack(args[0], args[1], args[2], kw.get("normal_codes"),
                                            kw.get("normal_lengths"))
    staged = kmer_cuda.region_stage(segments, total, "cuda")
    torch.cuda.synchronize()  # the pinned buffer is the thread's: the next region reuses it
    more = {} if not hasattr(plan, "cluster") else dict(cluster=C, clocks=clocks)
    return (lambda: kmer_cuda.region_run(staged, segments, args[3], kw["min_count"],
                                         plan.windows, **more)), C


def region_kernel_ms(case: str = "serial", cluster=None, args_kw=None) -> dict:
    """The region kernel alone on a region case's staged inputs (or on
    ``args_kw``): device ms of queued launches at the plan's cluster size
    (or ``cluster``), and, at the plan's size, a whole call's host µs (the
    median of single calls, its copies and its wait included); and the
    case's shapes."""
    import numpy as np

    from breakmer_tpu_torch.ops import kmer

    args, kw = args_kw or region_case(case)
    launch, C = region_launcher(args, kw, cluster)
    shape = {"sample": list(np.shape(args[0])), "ref": len(args[2]),
             "normal": (None if kw.get("normal_codes") is None
                        else list(np.shape(kw["normal_codes"])))}
    if launch is None:
        return {"shape": shape, "cluster": cluster, "device_ms": None}
    out = {"shape": shape, "cluster": C, "device_ms": queued_ms(launch)}
    if cluster is None:
        out["call_host_us"] = call_us(lambda: kmer.sample_only_kmers(*args, **kw, device="cuda"))
    return out


# the kernel's phases between its clock stamps; "marks a/b/c": one block,
# the reference's marks, the normal's, nothing; a cluster, the codes binned
# by owner, the cluster barrier, the owner's searches
PHASES = ("codes", "exchange", "sort", "index", "marks a", "marks b", "marks c", "runs",
          "output", "exit")
SWEEP_READS = (2, 5, 10, 20, 30, 47, 70, 100, 150, 200, 300, 600, 1232, 2400, 4400)


def phase_clocks(case: str = "serial", cluster=None, reps: int = 20) -> dict:
    """Each phase's clock cycles at a region case (the kernel's clock64
    stamps after each phase's barrier): per phase, the median over
    ``reps`` launches of the most any CTA took."""
    import numpy as np
    import torch

    args, kw = region_case(case)
    _, C = plan_of(args, kw, cluster)
    clocks = torch.zeros((C, len(PHASES) + 1), dtype=torch.int64, device="cuda")
    launch, C = region_launcher(args, kw, cluster, clocks)
    spans = []
    for _ in range(reps + 1):
        launch()
        torch.cuda.synchronize()
        spans.append(np.diff(clocks.cpu().numpy(), axis=1).max(axis=0))
    med = np.median(np.array(spans[1:]), axis=0)
    return {"case": case, "cluster": C, "cycles": dict(zip(PHASES, map(float, med))),
            "total": float(med.sum())}


def region_reading(cluster=None) -> dict:
    """K5 alone: at the serial shape and at the 100-gene panel's median
    region (47 reads of 101, a normal of 40) at each cluster size the card
    runs (device µs of queued launches) and at the plan's, with each
    call's host µs; the phase clocks at the plan's size and at one block;
    ``cluster`` forces one size for all. A checkout without cluster sizes
    gives its one block's times."""
    import numpy as np

    from breakmer_tpu_torch.ops import kmer_cuda

    runs = getattr(kmer_cuda, "cluster_sizes", lambda device: (1,))("cuda")
    sizes = runs if cluster is None else (cluster,)
    median = region_inputs(np.random.default_rng(0), R=47, L=101, normal=(40, 101))
    out = {"cluster_sizes": list(runs), "shapes": {}}
    for name, args_kw in (("serial", None), ("panel_median", median)):
        rows = {"plan": region_kernel_ms(name, cluster, args_kw)}
        for C in sizes:
            rows[f"C={C}"] = region_kernel_ms(name, C, args_kw)
        out["shapes"][name] = rows
    if hasattr(kmer_cuda, "cluster_sizes"):  # a checkout with the clock stamps
        out["phase_clocks"] = [phase_clocks("serial", cluster)]
        if cluster is None:
            out["phase_clocks"].append(phase_clocks("serial", 1))
    return out


def region_sweep() -> dict:
    """K5's device µs at each cluster size the card runs over samples of
    ``SWEEP_READS`` reads of 100 bases, a reference of 1,800 and a normal
    of four fifths as many reads of 102 (the 100-gene panel's median
    region has 47 reads and a normal of about 40): what
    ``kmer_cuda.CLUSTER_BY_WINDOWS`` is read from."""
    import numpy as np

    from breakmer_tpu_torch.ops import kmer_cuda

    rows = []
    for R in SWEEP_READS:
        args_kw = region_inputs(np.random.default_rng(R), R=R, normal=(max(1, 4 * R // 5), 102))
        row = {"reads": R, "windows": R * 86}
        for C in kmer_cuda.cluster_sizes("cuda"):
            launch, _ = region_launcher(*args_kw, C)
            row[f"C={C}"] = None if launch is None else queued_ms(launch) * 1e3
        rows.append(row)
    return {"sweep_us": rows}


class Recorded:
    """The serial path's sample_only_kmers calls while entered: each
    call's (args, kwargs), and the routes counted (``kmer.ROUTES``)."""

    def __enter__(self):
        from breakmer_tpu_torch import pipeline
        from breakmer_tpu_torch.ops import kmer

        self.pipeline, self.kmer, self.orig = pipeline, kmer, pipeline.sample_only_kmers
        self.calls, self.before = [], dict(kmer.ROUTES)

        def recorded(*args, **kw):
            self.calls.append((args, {n: v for n, v in kw.items() if n != "device"}))
            return self.orig(*args, **kw)

        pipeline.sample_only_kmers = recorded
        return self

    def __exit__(self, *exc):
        self.pipeline.sample_only_kmers = self.orig
        self.routes = {r: n - self.before[r] for r, n in self.kmer.ROUTES.items()}


def serial_run(cfg_kwargs: dict, out) -> "Recorded":
    """One serial Runner run on the card of a panel's config, recorded."""
    import torch

    from breakmer_tpu_torch.config import Config
    from breakmer_tpu_torch.runner import Runner

    cfg = Config(**{**cfg_kwargs, "analysis_dir": str(out), "device": "cuda",
                    "log_level": "WARNING", "batch_regions": False})
    runner = Runner(cfg)
    runner.setup()
    with Recorded() as rec:
        runner.run()
        torch.cuda.synchronize()
    return rec


def back_to_back_ms(launches) -> float:
    """The card's ms for the launches one after another: queued behind a
    sleep long enough for the host to queue them all (so the host's launch
    path is not in it), between two CUDA events."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for launch in launches[:3]:
        launch()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / 3 * len(launches)
    torch.cuda._sleep(int((2 * host_s + 2e-3) * 2e9))  # cycles at ~2 GHz
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for launch in launches:
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def panel_reading(work, reps: int = 5) -> dict:
    """The 100-gene panel of chip_smoke.py (scenario seed 5, read step 2, a
    matched normal), run serially on the card once, recorded; then every
    region the plan fuses, staged beforehand, launched back to back
    (``back_to_back_ms``; the median of ``reps`` rounds), with the cluster
    sizes the plan picked."""
    import collections

    from breakmer_tpu_torch.testing.scenarios import build_scenario

    cfg_kwargs, _ = build_scenario(5, work, n_genes=100, read_step=2,
                                   with_normal_germline=True, multi_sv_gene=True)
    rec = serial_run(cfg_kwargs, work / "out")
    launches, sizes = [], collections.Counter()
    for args, kw in rec.calls:
        launch, C = region_launcher(args, kw)
        if launch is not None:
            launches.append(launch)
            sizes[C] += 1
    rounds = [back_to_back_ms(launches) for _ in range(reps + 1)]
    return {"regions": len(rec.calls), "routes": rec.routes, "fused_launches": len(launches),
            "clusters": {str(c): n for c, n in sorted(sizes.items())},
            "launches_ms": statistics.median(rounds[1:]), "rounds_ms": rounds[1:]}


def deep_routes(work) -> dict:
    """The routes of ``tools/bench_panel_scaling``'s deep tiers at 100
    genes (``bench_panel.build_panel``), each run serially on the card:
    ``kmer.ROUTES`` counted, the samples' largest shape, and the cluster
    sizes the plan picked."""
    import collections

    import numpy as np

    from breakmer_tpu_torch import bench_panel
    from breakmer_tpu_torch.tools.bench_panel_scaling import DEEP_TIERS

    out = {}
    for step, read_len in DEEP_TIERS:
        tier = work / f"deep_{step}_{read_len}"
        tier.mkdir(parents=True)
        cfg = bench_panel.build_panel(tier, 100, step, read_len=read_len, device="cuda")
        rec = serial_run(cfg.__dict__, tier / "out")
        sizes = collections.Counter(plan_of(a, kw)[1] if plan_of(a, kw)[0].route == "fused"
                                    else 0 for a, kw in rec.calls)
        out[f"read_step {step}, read_len {read_len}"] = {
            "calls": len(rec.calls), "routes": rec.routes,
            "largest_sample": max((list(np.shape(a[0])) for a, _ in rec.calls), default=None),
            "clusters": {str(c): n for c, n in sorted(sizes.items())}}
    return out


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--call", action="store_true",
                    help="only the sample_only_kmers call's reading")
    ap.add_argument("--region", action="store_true",
                    help="only the region kernel's reading (sizes, phase clocks, host µs)")
    ap.add_argument("--cluster", type=int, default=None,
                    help="force the region kernel's cluster size in its readings")
    ap.add_argument("--sweep", action="store_true",
                    help="only the region kernel at each cluster size over sample sizes")
    ap.add_argument("--panel", action="store_true",
                    help="only the 100-gene panel's region launches back to back")
    ap.add_argument("--routes", action="store_true",
                    help="only the routes of bench_panel_scaling's deep tiers, run serially")
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
    if a.region or a.sweep or a.panel or a.routes:
        import tempfile
        from pathlib import Path

        out = {"tree": os.getcwd()}
        if a.region:
            out["region"] = region_reading(a.cluster)
        if a.sweep:
            out.update(region_sweep())
        with tempfile.TemporaryDirectory(prefix="kmer_time_") as tmp:
            if a.panel:
                (Path(tmp) / "panel").mkdir()
                out["panel"] = panel_reading(Path(tmp) / "panel")
            if a.routes:
                out["deep_routes"] = deep_routes(Path(tmp))
        print(json.dumps({**out, "card": card()}))
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
        out["functions"]["region_kmers serial"] = region_kernel_ms(cluster=a.cluster)
    out.update(call_profiles(rng, a.reps))
    out["card"] = card()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
