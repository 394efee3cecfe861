"""Repeat-mask subsystem.

Reference: utils.py setup_rmask + interval-overlap checks (SURVEY.md §2
#15): loads a UCSC-rmsk-derived BED into per-chromosome interval lists and
answers "what fraction of this genomic interval is repeat-masked" for the
filter stack. ``keep_repeat_regions`` bypasses at the filter layer.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


class RepeatMask:
    def __init__(self, intervals: Dict[str, List[Tuple[int, int]]]):
        """intervals: chrom -> [(start, end)] 0-based half-open."""
        self._starts: Dict[str, np.ndarray] = {}
        self._ends: Dict[str, np.ndarray] = {}
        for chrom, ivs in intervals.items():
            if not ivs:
                continue
            ivs = sorted(ivs)
            # merge overlapping
            merged = [list(ivs[0])]
            for s, e in ivs[1:]:
                if s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self._starts[chrom] = np.array([m[0] for m in merged], dtype=np.int64)
            self._ends[chrom] = np.array([m[1] for m in merged], dtype=np.int64)

    @classmethod
    def from_bed(cls, path: str | Path) -> "RepeatMask":
        intervals: Dict[str, List[Tuple[int, int]]] = {}
        with open(path) as fh:
            for raw in fh:
                line = raw.strip()
                if not line or line.startswith(("#", "track", "browser")):
                    continue
                cols = line.split()
                intervals.setdefault(cols[0], []).append((int(cols[1]), int(cols[2])))
        return cls(intervals)

    @classmethod
    def empty(cls) -> "RepeatMask":
        return cls({})

    def overlap_fraction(self, chrom: str, start: int, end: int) -> float:
        """Fraction of [start, end) covered by repeat intervals."""
        if end <= start or chrom not in self._starts:
            return 0.0
        starts, ends = self._starts[chrom], self._ends[chrom]
        lo = int(np.searchsorted(ends, start, side="right"))
        hi = int(np.searchsorted(starts, end, side="left"))
        covered = 0
        for i in range(lo, hi):
            covered += min(end, int(ends[i])) - max(start, int(starts[i]))
        return covered / (end - start)

    def contains(self, chrom: str, pos: int) -> bool:
        if chrom not in self._starts:
            return False
        starts, ends = self._starts[chrom], self._ends[chrom]
        i = int(np.searchsorted(starts, pos, side="right")) - 1
        return i >= 0 and pos < int(ends[i])
