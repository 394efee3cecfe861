"""Genome-scale bench of the port's seed index (``align.index.GenomeIndex``).

Port of ``tools/bench_genome_index.py``, with the same arguments and the
same JSON line. It builds the direct-addressed seed index over a
synthetic genome (a human-like chromosome layout, planted N runs) fed
through a streaming generator (one chromosome's codes alive at a time),
then measures resident RAM, query latency and throughput, window-fetch
decode speed and the index artifact's save and load:

    python -m breakmer_tpu_torch.tools.bench_genome_index [total_bp] [k] [--device cuda]

Default 1,000,000,000 bp, k=11, step=k (gfServer tile mode). The index
is host numpy, as in the JAX package; ``--device`` (default ``cuda``;
raises without a card unless ``cpu``) only names the machine's device
beside the host numbers, like every tool of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from breakmer_tpu_torch.align.index import GenomeIndex


def human_like_layout(total: int):
    """Chromosome lengths roughly proportional to hg38's 24 chroms."""
    rel = np.array([248, 242, 198, 190, 182, 171, 159, 145, 138, 134,
                    135, 133, 114, 107, 102, 90, 83, 80, 59, 64, 47, 51,
                    156, 57], dtype=np.float64)
    sizes = (rel / rel.sum() * total).astype(np.int64)
    return {f"chr{i + 1}": int(s) for i, s in enumerate(sizes)}


def gen_chroms(layout, seed=7):
    rng = np.random.default_rng(seed)
    for name, n in layout.items():
        codes = rng.integers(0, 4, n, dtype=np.int8)
        # plant centromere-like N runs: 1% of length in the middle
        mid = n // 2
        codes[mid:mid + max(1, n // 100)] = 4
        yield name, codes


def measure(total: int, k: int) -> dict:
    layout = human_like_layout(total)

    t0 = time.time()
    gi = GenomeIndex(gen_chroms(layout), k=k)  # streaming build
    build_s = time.time() - t0

    n_seeds = len(gi._positions)
    resident_mb = gi.nbytes / 1e6

    # query bench: 300 bp probes cut from the packed store itself
    rng = np.random.default_rng(1)
    probes = []
    names = gi.chroms
    for _ in range(200):
        c = names[int(rng.integers(0, len(names)))]
        L = gi.length(c)
        s = int(rng.integers(0, L - 400))
        q = gi.fetch_codes(c, s, s + 300)
        if (q >= 4).any():
            continue
        probes.append((c, s, q))
    t1 = time.time()
    found = 0
    for c, s, q in probes:
        wins = gi.candidates(q)
        if wins and wins[0].chrom == c and wins[0].t_start <= s <= wins[0].t_end:
            found += 1
    query_s = time.time() - t1
    qps = len(probes) / query_s if query_s else 0.0

    # fetch decode bench: 2 kb windows
    t2 = time.time()
    nfetch = 2000
    for i in range(nfetch):
        c = names[i % len(names)]
        gi.fetch_codes(c, 1000 + i * 997, 3000 + i * 997)
    fetch_s = time.time() - t2

    # the index artifact at scale: save, reload, verify
    fd, art = tempfile.mkstemp(suffix=".npz")
    os.close(fd)
    try:
        t3 = time.time()
        gi.save(art)
        save_s = time.time() - t3
        artifact_mb = os.path.getsize(art) / 1e6
        t4 = time.time()
        gi2 = GenomeIndex.load(art)
        load_s = time.time() - t4
        if not (np.array_equal(gi2._offsets, gi._offsets)
                and np.array_equal(gi2._positions, gi._positions)):
            raise RuntimeError("the reloaded index differs from the one saved")
    finally:
        os.unlink(art)

    return {
        "metric": "genome_index",
        "total_bp": total,
        "k": k,
        "step": gi.step,
        "n_seeds": n_seeds,
        "build_s": round(build_s, 1),
        "resident_mb": round(resident_mb, 1),
        "save_s": round(save_s, 1),
        "load_s": round(load_s, 1),
        "artifact_mb": round(artifact_mb, 1),
        "queries_per_s": round(qps, 1),
        "query_recall": round(found / max(1, len(probes)), 4),
        "fetch_2kb_us": round(1e6 * fetch_s / nfetch, 1),
    }


def main(argv=None) -> None:
    from breakmer_tpu_torch.device import resolve

    ap = argparse.ArgumentParser(prog="python -m breakmer_tpu_torch.tools.bench_genome_index")
    ap.add_argument("total_bp", nargs="?", type=float, default=1_000_000_000)
    ap.add_argument("k", nargs="?", type=int, default=11)
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    resolve(args.device)  # raises without a card unless cpu
    print(json.dumps(measure(int(args.total_bp), args.k)))


if __name__ == "__main__":
    main()
