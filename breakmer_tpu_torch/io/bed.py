"""Targets BED parsing.

Reference: sv_processor.py class runner parses the targets BED into
gene -> list of (chrom, start, end, name, feature) tuples (SURVEY.md §2 #3,
#16 — the optional 5th column is the feature annotation, exon/intron, used
for output rows and intron filtering).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional


@dataclasses.dataclass
class TargetInterval:
    chrom: str
    start: int   # 0-based inclusive
    end: int     # exclusive
    name: str
    feature: Optional[str] = None  # e.g. exon / intron


@dataclasses.dataclass
class TargetRegion:
    """All BED intervals sharing a target (gene) name, merged span."""

    name: str
    chrom: str
    start: int
    end: int
    intervals: List[TargetInterval]

    def span(self, buffer: int = 0) -> tuple:
        return (self.chrom, max(0, self.start - buffer), self.end + buffer)


def read_targets_bed(
    path: str | Path, gene_list: Optional[List[str]] = None
) -> Dict[str, TargetRegion]:
    """Parse a targets BED into an ordered {gene_name: TargetRegion}.

    Like the reference, multiple BED lines with the same name column are
    grouped into one target region spanning min(start)..max(end).
    """
    genes: "OrderedDict[str, List[TargetInterval]]" = OrderedDict()
    wanted = set(gene_list) if gene_list else None
    with open(path) as fh:
        for lineno, raw in enumerate(fh, 1):
            line = raw.strip()
            if not line or line.startswith(("#", "track", "browser")):
                continue
            cols = line.split("\t")
            if len(cols) < 4:
                cols = line.split()
            try:
                chrom, start, end, name = (
                    cols[0], int(cols[1]), int(cols[2]), cols[3]
                )
            except (IndexError, ValueError) as exc:
                raise ValueError(
                    f"{path}:{lineno}: malformed BED line (need "
                    f"chrom/start/end/name): {line[:80]!r}"
                ) from exc
            feature = cols[4] if len(cols) > 4 else None
            if wanted is not None and name not in wanted:
                continue
            genes.setdefault(name, []).append(
                TargetInterval(chrom, start, end, name, feature)
            )
    out: Dict[str, TargetRegion] = OrderedDict()
    for name, ivs in genes.items():
        chroms = {iv.chrom for iv in ivs}
        if len(chroms) != 1:
            raise ValueError(f"target {name} spans multiple chromosomes: {chroms}")
        out[name] = TargetRegion(
            name=name,
            chrom=ivs[0].chrom,
            start=min(iv.start for iv in ivs),
            end=max(iv.end for iv in ivs),
            intervals=ivs,
        )
    return out
