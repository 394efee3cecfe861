"""Profiler-event arithmetic: the device's busy time over a traced
window, kernel time by name, and the idle gaps labelled by what the host
was doing (the benchmark's own ``svbench.*`` spans).

The device activities are the kernels, copies and memsets of a
``torch.profiler`` trace (``kineto_results.events()``), the same
arithmetic as the program's ``timing.device_ns``; kernels that no torch
op launched (the program's ctypes launches) count too.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _label(spans: List[Tuple[int, int, str]], t: int) -> str:
    """The innermost benchmark span around host time ``t``."""
    best: Optional[Tuple[int, str]] = None
    for s, e, name in spans:
        if s <= t < e and (best is None or e - s < best[0]):
            best = (e - s, name)
    if best is None:
        return "harness (between samples)"
    name = best[1]
    if name == "svbench.sample":
        return "runner (outside every METER stage)"
    return name.replace("svbench.stage.", "stage ")


def summarize(events, window_s: float) -> Dict[str, object]:
    from torch.autograd import DeviceType

    dev: List[Tuple[int, int, str]] = []
    spans: List[Tuple[int, int, str]] = []
    for e in events:
        if e.name().startswith("svbench."):  # a span's host op, or its mirror on the device timeline
            if e.device_type() != DeviceType.CUDA:
                spans.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() == DeviceType.CUDA:
            dev.append((e.start_ns(), e.end_ns(), e.name()))
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, n in dev:
        by_name[n] += (e - s) / 1e9
    busy = _union([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps: Dict[str, float] = defaultdict(float)
    if busy:
        lo = min((s for s, _e, n in spans if n == "svbench.sample"), default=busy[0][0])
        hi = max((e for _s, e, n in spans if n == "svbench.sample"), default=busy[-1][1])
        edges = [(lo, lo)] + busy + [(hi, hi)]
        spans.sort()
        for (_s0, e0), (s1, _e1) in zip(edges, edges[1:]):
            if s1 > e0:
                gaps[_label(spans, (e0 + s1) // 2)] += (s1 - e0) / 1e9
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernel_s": dict(by_name),
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:10],
    }
