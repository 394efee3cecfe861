"""Regions/s of two checkouts of the port on one card, run in turns.

    python /path/to/breakmer_tpu_torch/tools/panel_ab.py DIR_A DIR_B [--pairs 12]
        [--paths serial,batched] [--genes 100] [--device cuda]

``DIR_A`` and ``DIR_B`` are the roots of two checkouts (say a ``git
archive`` of the parent under ``build/`` and the working tree). The
script builds the 100-gene panel of ``chip_smoke.py`` once (scenario
seed 5, read step 2, a matched normal; ``--genes`` cuts it), with the
scenario copy of the checkout it lives in, then starts one worker
process in each directory: the worker imports the ``breakmer_tpu_torch``
found there and its Runner. Each worker runs the panel once cold on each
path. Then, for each path and each of ``pairs`` pairs, the two workers
run it in turn, the order alternating (A B, B A, ...). A run is
``Runner.setup()`` untimed, then ``Runner.run()`` timed up to the card's
end, as ``chip_smoke.py`` times it, with nothing recording the SW calls;
the batched path runs at nprocs 1. ``--device cpu`` runs the same on the
host: a check of the script, not a measurement of the card.

Prints one JSON line a timed run, then one summary line: for each path
and checkout the median, least and largest regions/s, and whether every
run of both wrote the same svs.out; the card's name and power limit.
Both workers stop before it exits.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
PREFIX = "RESULT "


def worker(cfg_file: str) -> None:
    """Runs one panel a line of stdin ({"path", "out", "refdata", "device"}) with the
    checkout of the current directory; answers one RESULT line each."""
    sys.path.insert(0, os.getcwd())
    import torch

    from breakmer_tpu_torch import runner as rmod

    kw = json.loads(Path(cfg_file).read_text())
    for line in sys.stdin:
        job = json.loads(line)
        out = Path(job["out"])
        cfg = rmod.Config(**{**kw, "analysis_dir": str(out), "reference_data_dir": job["refdata"],
                             "device": job["device"], "log_level": "WARNING", "nprocs": 1,
                             "batch_regions": job["path"] == "batched"})
        run = rmod.Runner(cfg)
        sync = torch.cuda.synchronize if job["device"] != "cpu" else (lambda: None)
        run.setup()
        sync()
        t0 = time.perf_counter()
        run.run()
        sync()
        run_s = time.perf_counter() - t0
        metrics = json.loads((out / "metrics.json").read_text())
        svs = (out / "output" / f"{kw['analysis_name']}_svs.out").read_bytes()
        print(PREFIX + json.dumps({
            "run_s": run_s, "regions_per_s": metrics["targets"] / run_s,
            "errors": len(metrics["errors"]), "stage_s": metrics["stage_s"],
            "svs_sha256": hashlib.sha256(svs).hexdigest()}), flush=True)


class Worker:
    def __init__(self, tree: Path, cfg_file: Path, work: Path, device: str):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        self.tree, self.work, self.device, self.n = tree, work, device, 0
        self.proc = subprocess.Popen(
            [sys.executable, str(HERE), "--worker", str(cfg_file)], cwd=tree, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def run(self, path: str) -> dict:
        self.n += 1
        job = {"path": path, "out": str(self.work / f"run{self.n}"),
               "refdata": str(self.work / "refdata"), "device": self.device}
        self.proc.stdin.write(json.dumps(job) + "\n")
        self.proc.stdin.flush()
        for line in self.proc.stdout:
            if line.startswith(PREFIX):
                res = json.loads(line[len(PREFIX):])
                if res["errors"]:
                    raise RuntimeError(f"{self.tree}: {res['errors']} region errors")
                return res
        raise RuntimeError(f"worker in {self.tree} ended (code {self.proc.wait()})")

    def stop(self) -> None:
        if self.proc.stdin:
            self.proc.stdin.close()
        try:
            self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="panel_ab.py")
    p.add_argument("tree_a")
    p.add_argument("tree_b")
    p.add_argument("--pairs", type=int, default=12)
    p.add_argument("--paths", default="serial,batched")
    p.add_argument("--genes", type=int, default=100)
    p.add_argument("--device", default="cuda")
    p.add_argument("--work", default=str(HERE.parents[2] / "build" / "panel_ab"))
    args = p.parse_args(argv)
    sys.path.insert(0, str(HERE.parents[2]))
    import shutil

    import torch

    from breakmer_tpu_torch.testing.scenarios import build_scenario
    from breakmer_tpu_torch.timing import card_line

    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("panel_ab: no CUDA card (--device cpu runs on the host)")
    work = Path(args.work)
    shutil.rmtree(work, ignore_errors=True)
    (work / "panel").mkdir(parents=True)
    cfg_kwargs, _ = build_scenario(5, work / "panel", n_genes=args.genes, read_step=2,
                                   with_normal_germline=True, multi_sv_gene=True)
    cfg_file = work / "cfg.json"
    cfg_file.write_text(json.dumps(cfg_kwargs))
    trees = {"A": Path(args.tree_a).resolve(), "B": Path(args.tree_b).resolve()}
    workers = {}
    try:
        for name, tree in trees.items():
            workers[name] = Worker(tree, cfg_file, work / name, args.device)
        paths = args.paths.split(",")
        for path in paths:
            for w in workers.values():
                w.run(path)  # cold: kernels built and loaded, first-use set-up
        runs = {(path, name): [] for path in paths for name in trees}
        hashes = set()
        for path in paths:
            for i in range(args.pairs):
                for name in ("AB" if i % 2 == 0 else "BA"):
                    res = workers[name].run(path)
                    runs[path, name].append(res["regions_per_s"])
                    hashes.add(res["svs_sha256"])
                    print(json.dumps({"path": path, "pair": i, "tree": name, **res}),
                          flush=True)
    finally:
        for w in workers.values():
            w.stop()
    summary = {f"{path} {name}": {"tree": str(trees[name]), "median": statistics.median(v),
                                  "min": min(v), "max": max(v), "runs": len(v)}
               for (path, name), v in runs.items()}
    print(json.dumps({"regions_per_s": summary, "svs_identical": len(hashes) == 1,
                      "device": args.device,
                      "card": card_line() if args.device != "cpu" else None}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
    else:
        main()
