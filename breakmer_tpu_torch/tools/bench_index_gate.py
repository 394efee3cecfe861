"""Genome-index build regression gate of the port.

Port of ``tools/bench_index_gate.py``: a fixed 100 Mbp build of the
port's ``GenomeIndex``, run ``--runs`` times in one process, gated on the
median against a baseline; the threshold is 0.70x, so only a real
(>= 40 %) build-path regression trips it while host weather does not.

    python -m breakmer_tpu_torch.tools.bench_index_gate --update   # write the baseline
    python -m breakmer_tpu_torch.tools.bench_index_gate            # exit 1 below 0.70x

Against the JAX tool: the baseline is the port's own,
``breakmer_tpu_torch/bench_index_cpu_baseline.json``, which no commit
holds (a machine records its own with ``--update``; without it the gate
exits 2), and the committed ``bench_index_baseline.json`` is never read
or written. ``--device`` (default ``cuda``; raises without a card unless
``cpu``) names the machine's device; the build is host numpy. Never run
it beside another bench or sweep.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from breakmer_tpu_torch.align.index import GenomeIndex
from breakmer_tpu_torch.tools.bench_genome_index import gen_chroms, human_like_layout

BASELINE = Path(__file__).resolve().parents[1] / "bench_index_cpu_baseline.json"
TOTAL_BP = 100_000_000
THRESHOLD = 0.70


def one_build() -> float:
    layout = human_like_layout(TOTAL_BP)
    t0 = time.time()
    gi = GenomeIndex(gen_chroms(layout), k=11)
    dt = time.time() - t0
    if len(gi._positions) == 0:
        raise RuntimeError("the index holds no seed")
    return dt


def main(argv=None) -> int:
    from breakmer_tpu_torch.device import resolve

    ap = argparse.ArgumentParser(prog="python -m breakmer_tpu_torch.tools.bench_index_gate")
    ap.add_argument("--update", action="store_true")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    resolve(args.device)  # raises without a card unless cpu
    times = sorted(one_build() for _ in range(max(1, args.runs)))
    med = times[len(times) // 2]
    result = {
        "total_bp": TOTAL_BP,
        "build_s": round(med, 2),
        "build_s_all": [round(t, 2) for t in times],
        "mbp_per_s": round(TOTAL_BP / 1e6 / med, 1),
    }
    if args.update:
        BASELINE.write_text(json.dumps(result, indent=1) + "\n")
        print(json.dumps({"index_gate": result, "baseline": "written"}))
        return 0
    if not BASELINE.exists():
        print(json.dumps({
            "index_gate": result, "ok": False,
            "error": f"{BASELINE.name} missing: run --update on a known-good idle host first"}))
        return 2
    base = json.loads(BASELINE.read_text())
    drift = round(base["build_s"] / med, 3)  # > 1: faster than the baseline
    ok = drift >= THRESHOLD
    print(json.dumps({"index_gate": result, "baseline_build_s": base["build_s"],
                      "drift_vs_baseline": drift, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
