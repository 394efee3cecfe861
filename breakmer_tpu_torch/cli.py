"""CLI entry point.

Reference: breakmer.py ``__main__`` (SURVEY.md §2 #1): optparse CLI taking
a config file plus option overrides; modes: full run and reference-data
preset (SURVEY.md §3.4). Usage:

    python -m breakmer_tpu_torch.cli run <config> [--nprocs N] [--genes A,B] [--profile] ...
    python -m breakmer_tpu_torch.cli preset <config>
    python -m breakmer_tpu_torch.cli version
    python -m breakmer_tpu_torch.cli check

The config's ``device`` (auto | cuda | cpu) picks where the k-mer engine
and the SW kernel run; see breakmer_tpu_torch.device.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from breakmer_tpu_torch import __version__
from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.runner import Runner


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="breakmer_tpu_torch",
        description="structural-variant caller (BreaKmer-class), PyTorch/CUDA port",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def add_common(sp):
        sp.add_argument("config", help="JSON or key=value config file")
        sp.add_argument("--analysis-dir", dest="analysis_dir")
        sp.add_argument("--analysis-name", dest="analysis_name")
        sp.add_argument("-p", "--nprocs", dest="nprocs", type=int)
        sp.add_argument("-g", "--gene-list", dest="gene_list")
        sp.add_argument("--kmer-size", dest="kmer_size", type=int)
        sp.add_argument("--indel-size", dest="indel_size", type=int)
        sp.add_argument("--keep-repeat-regions", dest="keep_repeat_regions",
                        action="store_true", default=None)
        sp.add_argument("--keep-intron-vars", dest="keep_intron_vars",
                        action="store_true", default=None)
        sp.add_argument("--log-level", dest="log_level")

    run_p = sub.add_parser("run", help="full analysis run")
    add_common(run_p)
    run_p.add_argument("--resume", action="store_true",
                       help="resume from the per-region completion ledger")
    run_p.add_argument("--profile", action="store_true",
                       help="capture a torch.profiler trace to <analysis_dir>/trace")

    preset_p = sub.add_parser(
        "preset", help="pre-build reference data caches (reference preset mode)"
    )
    add_common(preset_p)

    sub.add_parser("version", help="print version")
    sub.add_parser(
        "check",
        help="environment self-check (reference: utils.py tool self-tests)",
    )
    return p


def load_config(args: argparse.Namespace) -> Config:
    overrides = {
        k: v
        for k, v in vars(args).items()
        if k not in ("command", "config", "resume", "profile") and v is not None
    }
    return Config.from_file(args.config, **overrides)


def run_check() -> int:
    """Startup self-checks: the CUDA card, the kernel build, the k-mer
    engine and the SW kernel on the card, and the native IO library."""
    import numpy as np
    import torch

    from breakmer_tpu_torch import native
    from breakmer_tpu_torch.device import resolve

    print(f"torch {torch.__version__}; CUDA {torch.version.cuda}")
    try:
        device = resolve("cuda")
    except RuntimeError as exc:
        print(f"CUDA device: FAIL ({exc})")
        return 1
    print(f"CUDA device: {torch.cuda.get_device_name(device)}")
    failures = 0
    try:
        from breakmer_tpu_torch import _build

        print(f"kernel build: OK ({_build.build()})")
    except RuntimeError as exc:
        failures += 1
        print(f"kernel build: FAIL ({exc})")
    try:
        from breakmer_tpu_torch.ops.kmer import kmer_codes

        kmer_codes(torch.zeros((2, 20), dtype=torch.int8, device=device),
                   torch.full((2,), 20, dtype=torch.int32, device=device), 15)
        torch.cuda.synchronize(device)
        print("kmer engine: OK")
    except RuntimeError as exc:
        failures += 1
        print(f"kmer engine: FAIL ({exc})")
    try:
        from breakmer_tpu_torch.ops.sw import sw_score_batch

        sw_score_batch(np.zeros((8, 128), np.int8), np.zeros((8, 128), np.int8),
                       device=device)
        print("SW kernel: OK")
    except RuntimeError as exc:
        failures += 1
        print(f"SW kernel: FAIL ({exc})")
    print(f"native IO library: {'OK' if native.available() else 'not built (pure-python fallbacks active)'}")
    print("self-check:", "PASS" if failures == 0 else f"{failures} FAILURES")
    return 1 if failures else 0


def run_profiled(runner: Runner, cfg: Config, resume: bool = False) -> None:
    """``runner.run`` under ``torch.profiler``: host activity, plus the
    card's kernels when the run's device is a card, and every METER stage
    as a ``breakmer.<stage>`` range on the same timeline. A Runner not yet
    set up sets up inside the trace too. The Chrome trace goes to
    ``<analysis_dir>/trace/trace.json`` (the JAX package writes its
    ``jax.profiler`` trace to the same directory)."""
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    from breakmer_tpu_torch.device import resolve
    from breakmer_tpu_torch.utils.meter import METER

    activities = [ProfilerActivity.CPU]
    if resolve(cfg.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(cfg.analysis_dir) / "trace"
    METER.profile = True
    try:
        with profile(activities=activities) as prof:
            runner.run(resume=resume)
            if ProfilerActivity.CUDA in activities:
                torch.cuda.synchronize()
    finally:
        METER.profile = False
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "version":
        print(__version__)
        return 0
    if args.command == "check":
        return run_check()
    cfg = load_config(args)
    runner = Runner(cfg)
    if args.command == "preset":
        runner.setup()
        runner.preset_ref_data()
        print(f"preset complete: {len(runner.targets)} targets cached")
        return 0
    if args.profile:
        run_profiled(runner, cfg, resume=args.resume)  # set-up on the trace too
    else:
        runner.setup()
        runner.run(resume=args.resume)
    print(f"{runner.total_calls} SV calls written to "
          f"{cfg.analysis_dir}/output/{cfg.analysis_name}_svs.out")
    return 0


if __name__ == "__main__":
    sys.exit(main())
