"""Device time of the SW kernel's wrapper at given shapes, on the card.

    python /path/to/breakmer_tpu_torch/tools/sw_time.py B,Lq,Lt [B,Lq,Lt ...]
    python /path/to/breakmer_tpu_torch/tools/sw_time.py --cases NAME[:no_n] ...

Run from the root of a checkout, it times the ``sw_score_cuda`` of the
``breakmer_tpu_torch`` found there (the current directory goes first on
``sys.path``), so one copy of this script times two checkouts alike: run
it from each, in turns, within one session on one card. Inputs are
random codes 0..3 from seed 0 (the no_n form). Each shape's time is the
median of 5 windows of 10 calls that the card runs back to back (it
first sleeps while the host queues them), so the host's launch path is
not in it. Each shape's host time a call (``sw_host_us``) is the median
of 5 windows of 200 calls made back to back on the host clock, divided
by 200: the wrapper's launch path, checks to the launch (the card runs
behind and is waited for after each window). ``sw_unpacked_device_ms``
times the unpacked form forced (``unpacked=True``) the same way. Prints
one JSON line with the times and the card. It keeps its own copy of that timing
(``timing.queued_ms``), since the checkout it times may predate it.

``--cases`` instead runs each named case of this script's own
``testing/sw_domain.py`` (``:no_n`` asks for the no_n form) through the
checkout's ``sw_score_cuda`` and its plain ``sw_score`` on the CPU, and
prints one JSON line a case with both answers (a refusal as its
exception) and the card: the card's faults of a checkout, shown by input.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


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


def host_us(fn, n: int = 200, windows: int = 5) -> float:
    import torch

    fn()
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def show_cases(names) -> None:
    import importlib.util

    import torch

    from breakmer_tpu_torch.ops import sw_cuda
    from breakmer_tpu_torch.ops.sw import sw_score

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "testing",
                        "sw_domain.py")
    spec = importlib.util.spec_from_file_location("sw_domain", path)
    domain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(domain)
    card = _card()
    for arg in names:
        name, _, flag = arg.partition(":")
        c = domain.case(name)
        q, t = torch.from_numpy(c["q"]), torch.from_numpy(c["t"])
        plain = [x.tolist() for x in sw_score(q, t, c["params"])]
        try:
            got = [x.cpu().tolist() for x in sw_cuda.sw_score_cuda(
                q.cuda(), t.cuda(), c["params"], no_n=flag == "no_n")]
        except ValueError as exc:
            got = f"ValueError: {exc}"
        print(json.dumps({"case": name, "no_n": flag == "no_n", "plain": plain, "card": got,
                          "equal": got == plain, "tree": os.getcwd(), "device": card}))


def main(argv=None) -> None:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from breakmer_tpu_torch.ops import sw_cuda

    if not torch.cuda.is_available():
        raise RuntimeError("sw_time needs a CUDA card")
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--cases"]:
        show_cases(args[1:])
        return
    shapes = [tuple(int(x) for x in a.split(",")) for a in args]
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    out, host, unpacked = {}, {}, {}
    for B, Lq, Lt in shapes:
        q = torch.from_numpy(rng.integers(0, 4, (B, Lq)).astype(np.int8)).to(dev)
        t = torch.from_numpy(rng.integers(0, 4, (B, Lt)).astype(np.int8)).to(dev)
        out[f"{B}x{Lq}x{Lt}"] = queued_ms(lambda: sw_cuda.sw_score_cuda(q, t, no_n=True))
        host[f"{B}x{Lq}x{Lt}"] = host_us(lambda: sw_cuda.sw_score_cuda(q, t, no_n=True))
        unpacked[f"{B}x{Lq}x{Lt}"] = queued_ms(
            lambda: sw_cuda.sw_score_cuda(q, t, no_n=True, unpacked=True))
    print(json.dumps({"sw_device_ms": out, "sw_host_us": host,
                      "sw_unpacked_device_ms": unpacked, "tree": os.getcwd(), "card": _card()}))


if __name__ == "__main__":
    main()
