"""SAM parsing (text alignments).

The environment has no pysam/htslib (SURVEY.md §7); alignment ingest is
first-party. This module handles the text SAM path; BGZF/BAM lives in
bam.py. Exposes the fields the SV-read extractor needs (reference:
sv_processor.py target.extract_bam_reads uses pysam fetch + per-read flag /
CIGAR / mate info).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")

FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800


@dataclasses.dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str       # '*' if unmapped
    pos: int         # 0-based leftmost mapping position (-1 if unmapped)
    mapq: int
    cigar: List[Tuple[int, str]]  # [(length, op)]
    rnext: str       # mate chrom, '=' resolved to rname
    pnext: int       # 0-based mate position (-1 if none)
    tlen: int
    seq: str
    qual: List[int]  # phred scores; empty if '*'

    # -- flag helpers ------------------------------------------------------
    @property
    def is_paired(self) -> bool:
        return bool(self.flag & FLAG_PAIRED)

    @property
    def is_proper_pair(self) -> bool:
        return bool(self.flag & FLAG_PROPER_PAIR)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def mate_unmapped(self) -> bool:
        return bool(self.flag & FLAG_MATE_UNMAPPED)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def mate_reverse(self) -> bool:
        return bool(self.flag & FLAG_MATE_REVERSE)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FLAG_SECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    @property
    def is_dup(self) -> bool:
        return bool(self.flag & FLAG_DUP)

    # -- CIGAR helpers -----------------------------------------------------
    def soft_clips(self) -> Tuple[int, int]:
        """(left, right) soft-clip lengths."""
        left = right = 0
        if self.cigar:
            if self.cigar[0][1] == "S":
                left = self.cigar[0][0]
            if len(self.cigar) > 1 and self.cigar[-1][1] == "S":
                right = self.cigar[-1][0]
            elif len(self.cigar) == 1 and self.cigar[0][1] == "S":
                right = 0
        return left, right

    def reference_end(self) -> int:
        """0-based exclusive end on the reference."""
        span = sum(n for n, op in self.cigar if op in "MDN=X")
        return self.pos + span


def parse_cigar(cigar: str) -> List[Tuple[int, str]]:
    if cigar == "*" or not cigar:
        return []
    return [(int(n), op) for n, op in _CIGAR_RE.findall(cigar)]


def parse_sam_line(line: str) -> SamRecord:
    cols = line.rstrip("\n").split("\t")
    if len(cols) < 11:
        raise ValueError(
            f"malformed SAM line ({len(cols)} fields, need >=11): "
            f"{line[:80]!r}"
        )
    rname = cols[2]
    rnext = cols[6]
    if rnext == "=":
        rnext = rname
    if cols[10] == "*":
        qual = []
    else:
        import numpy as _np

        qual = (_np.frombuffer(cols[10].encode(), _np.uint8) - 33).tolist()
    return SamRecord(
        qname=cols[0],
        flag=int(cols[1]),
        rname=rname,
        pos=int(cols[3]) - 1,
        mapq=int(cols[4]),
        cigar=parse_cigar(cols[5]),
        rnext=rnext,
        pnext=int(cols[7]) - 1,
        tlen=int(cols[8]),
        seq=cols[9],
        qual=qual,
    )


def record_overlaps(rec: SamRecord, region: Tuple[str, int, int]) -> bool:
    """pysam.fetch-style region predicate (0-based half-open); unmapped
    reads count when their placeholder position is inside the region."""
    chrom, start, end = region
    if rec.is_unmapped:
        return rec.rname == chrom and start <= rec.pos < end
    if rec.rname != chrom:
        return False
    return rec.reference_end() > start and rec.pos < end


def read_sam(
    path: str | Path,
    region: Optional[Tuple[str, int, int]] = None,
) -> Iterator[SamRecord]:
    """Iterate records, optionally restricted to reads overlapping
    ``(chrom, start, end)`` (0-based half-open) — the reference's
    pysam.fetch(region) analog, by linear scan (fine for targeted panels;
    BAM+index random access arrives with bam.py)."""
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            if line.startswith("@"):
                continue
            try:
                rec = parse_sam_line(line)
            except (ValueError, IndexError) as exc:
                raise ValueError(f"{path}:{lineno}: {exc}") from exc
            if region is not None and not record_overlaps(rec, region):
                continue
            yield rec
