"""Run one cell of the benchmark once and print its result line.

    python3 -m svbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for; with ``--rehearse`` every cell at a tiny size on the CPU instead,
printing no device metric. A measured run that finds no card exits 2 and
prints no result; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
# the program's kernel builds and any compiler cache stay inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(REPO / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(REPO / "build" / "triton"))
os.environ["USE_FLAX"] = "0"

from svbench import harness  # noqa: E402


def _fail(msg: str, code: int = 2) -> None:
    print(f"svbench: {msg}", file=sys.stderr)
    sys.exit(code)


def measured(bench: dict, cell: dict, args) -> dict:
    missing = harness.card_missing(int(cell["chips"]))
    if missing:
        _fail(f"{cell['name']} {missing}")
    import torch

    import breakmer_tpu_torch  # noqa: F401  (the system under test; without it nothing runs)
    out = harness.run_cell(cell, args.seed, float(args.seconds), bool(args.trace), t_start=T_START)
    rec = out["record"]
    kind = "per_layer" if args.trace else "end_to_end"
    names = [(m["name"], m["unit"]) for m in bench[kind]
             if "workloads" not in m or cell["name"] in m["workloads"]]
    metrics = harness.read_metrics(names, rec)
    found = harness.forbidden_modules()
    if found:
        _fail(f"modules that the port must not load are in sys.modules: {', '.join(found)}", 3)
    checks = out["checks"]
    correct = all(harness.within(v) for v in checks.values())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(cell["chips"]),
              "memory_peak_bytes": int(out["dev_peak"])}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if args.trace:
        t = rec["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["info"] = {"passes": len(rec["passes"]), "window_s": rec["window_s"], "gen_s": out["gen_s"],
                    "walls": [p["wall"] for p in rec["passes"]], "peak_rss_by_phase": rec["peak_rss_by_phase"],
                    "detail": out["detail"]}
    line["checks"] = checks
    for k, v in checks.items():
        print(harness.check_line(k, v), file=sys.stderr)
    return line


def rehearse(cells: list) -> int:
    """Every cell at a tiny size on the CPU: the same set-up, window and
    checks, with the kernels' plain versions. No device metric."""
    bad = 0
    for cell in cells:
        t0 = time.time()
        out = harness.run_cell(cell, 1, 0.0, False, t_start=t0, rehearse=True)
        checks = out["checks"]
        ok = all(harness.within(v) for v in checks.values())
        bad += not ok
        print(json.dumps({"rehearsal": cell["name"], "correct": ok, "attempted": out["attempted"],
                          "failed": out["failed"], "seconds": round(time.time() - t0, 1),
                          "passes": len(out["record"]["passes"]), "detail": out["detail"],
                          "checks": checks}))
    found = harness.forbidden_modules()
    if found:
        print(f"svbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="svbench.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true", help="every cell, tiny, on the CPU")
    args = ap.parse_args(argv)
    bench_path = REPO / "BENCHMARK.json"
    if not bench_path.exists():
        _fail("no BENCHMARK.json at the checkout's root", 1)
    bench = json.loads(bench_path.read_text())
    if args.rehearse:
        cells = [harness.find_cell(bench, args.workload)] if args.workload else bench["workloads"]
        return rehearse(cells)
    if not args.workload:
        _fail("--workload is required", 1)
    line = measured(bench, harness.find_cell(bench, args.workload), args)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
