"""Panel throughput scaling: regions/s and reads/s against panel size,
with a CPU column and a card column at every point.

Port of ``tools/bench_panel_scaling.py``: the same points (``SIZES`` at
read_step 6 with 100 bp reads, then ``DEEP_TIERS`` at 100 genes) and the
same record, with the card in place of the TPU (``"cuda"`` columns,
``cuda_speedup_warm``, ``first_cuda_win``). Each (point, device) runs in
a subprocess of its own: one cold run, then two warm runs of the port's
batched Runner (``bench_panel.build_panel`` / ``run_once``); the number
is the median warm run. The two columns are interleaved per point, so
host drift hits both alike. Run it on an otherwise idle host.

    python -m breakmer_tpu_torch.tools.bench_panel_scaling [out.json] [--device cuda]
    python -m breakmer_tpu_torch.tools.bench_panel_scaling --one <device> <n_genes> <step> <read_len>

``--device`` names the card column's device (default ``cuda``; it raises
without a card). With ``--device cpu`` only the CPU column runs.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from breakmer_tpu_torch.tools import REPO

SIZES = [20, 50, 100, 200, 400]
# deep tiers at 100 genes: (read_step, read_len)
DEEP_TIERS = [(2, 100), (1, 250)]


def one_point(device: str, n_genes: int, read_step: int, read_len: int) -> dict:
    from breakmer_tpu_torch.bench_panel import build_panel, run_once
    from breakmer_tpu_torch.device import resolve

    dev = resolve(device)  # raises without a card unless cpu
    work = Path(tempfile.mkdtemp(prefix="breakmer_torch_scale_"))
    try:
        t0 = time.time()
        cfg = build_panel(work, n_genes, read_step, read_len=read_len, device=str(dev))
        fixture_s = time.time() - t0
        cold = run_once(cfg)
        warms = []
        for _ in range(2):
            shutil.rmtree(cfg.analysis_dir, ignore_errors=True)
            warms.append(run_once(cfg))
        warm = sorted(warms, key=lambda w: w["elapsed_s"])[len(warms) // 2]
        return {
            "platform": dev.type,
            "n_genes": n_genes,
            "read_step": read_step,
            "read_len": read_len,
            "targets": warm["targets"],
            "records": warm["records"],
            "calls": warm["calls"],
            "fixture_s": round(fixture_s, 2),
            "cold_s": round(cold["elapsed_s"], 2),
            "warm_s": round(warm["elapsed_s"], 3),
            "warm_s_all": [round(w["elapsed_s"], 3) for w in warms],
            "regions_per_s": round(warm["targets"] / warm["elapsed_s"], 1),
            "reads_per_s": round(warm["records"] / warm["elapsed_s"], 1),
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_sub(device: str, n_genes: int, step: int, read_len: int) -> dict:
    """One (point, device) in a fresh process, from the checkout's root."""
    cmd = [sys.executable, "-m", "breakmer_tpu_torch.tools.bench_panel_scaling", "--one",
           device, str(n_genes), str(step), str(read_len)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=3600,
                          cwd=str(REPO), env=env)
    for line in reversed(proc.stdout.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"scaling subprocess produced no JSON: {proc.stderr[-2000:]}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--one":
        print(json.dumps(one_point(argv[1], int(argv[2]), int(argv[3]), int(argv[4]))))
        return
    ap = argparse.ArgumentParser(prog="python -m breakmer_tpu_torch.tools.bench_panel_scaling")
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", help="the card column: cuda or cuda:N "
                                                     "(cpu: the CPU column alone)")
    args = ap.parse_args(argv)
    from breakmer_tpu_torch.device import resolve

    card = resolve(args.device)  # raises without a card unless cpu
    columns = ["cpu"] if card.type == "cpu" else ["cpu", str(card)]
    out_path = Path(args.out) if args.out else None
    points = []
    shapes = [(n, 6, 100) for n in SIZES] + [(100, step, rl) for step, rl in DEEP_TIERS]
    for n, step, rl in shapes:
        row = {"n_genes": n, "read_step": step, "read_len": rl}
        # interleave: cpu, then the card, back to back on the same fixture shape
        for device in columns:
            r = run_sub(device, n, step, rl)
            row[r["platform"]] = {
                k: r[k] for k in ("cold_s", "warm_s", "warm_s_all",
                                  "regions_per_s", "reads_per_s", "records", "calls")}
        if {"cpu", "cuda"} <= set(row):
            row["cuda_speedup_warm"] = round(row["cpu"]["warm_s"] / row["cuda"]["warm_s"], 3)
        print(json.dumps(row), flush=True)
        points.append(row)
    crossover = [p for p in points if p.get("cuda_speedup_warm", 0) > 1.0]
    artifact = {
        "metric": "panel_scaling_cpu_vs_cuda",
        "points": points,
        "crossover": (
            {"first_cuda_win": {k: crossover[0][k] for k in
                                ("n_genes", "read_step", "read_len", "cuda_speedup_warm")}}
            if crossover else
            {"first_cuda_win": None,
             "note": "the card never beat the CPU on these panels"}),
        "note": (
            "warm_s is the comparable number (median of 2 same-process "
            "warm runs, a subprocess per device); cold_s includes the "
            "process's first CUDA work. cpu/cuda subprocesses interleaved per point."
        ),
    }
    if card.type == "cuda":
        from breakmer_tpu_torch.timing import card_line

        artifact["card"] = card_line()
    line = json.dumps(artifact)
    print(line)
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(line + "\n")


if __name__ == "__main__":
    main()
