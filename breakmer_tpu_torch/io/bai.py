"""BAI (BAM index) reading, writing, and region queries — first party.

The reference relies on pysam/htslib for indexed BAM access (SURVEY.md §2
#6, target.extract_bam_reads: pysam fetch over a region); this module is
the htslib-free equivalent so whole-genome BAMs don't pay a linear decode
per region (ROADMAP: BAI/CSI support). Format: SAM spec v1.6 §5.2 —
R-tree binning (5 levels, bins 0..37449) plus a 16 kb-window linear
index of virtual file offsets (coffset << 16 | uoffset).

Index creation lives here too (build_bai / io.bam.write_bam(index=True)),
replacing `samtools index` for first-party-written BAMs.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Tuple

BAI_MAGIC = b"BAI\x01"
PSEUDO_BIN = 37450
LINEAR_SHIFT = 14  # 16 kb windows
MAX_BIN = 37449


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin containing [beg, end) (SAM spec §5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins that may contain records overlapping [beg, end)."""
    end -= 1
    bins = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


class BaiIndex:
    """Parsed index: per reference, bin -> chunk list and the linear
    index of 16 kb-window start offsets."""

    def __init__(
        self,
        bins: List[Dict[int, List[Tuple[int, int]]]],
        linear: List[List[int]],
    ):
        self.bins = bins
        self.linear = linear

    @property
    def n_ref(self) -> int:
        return len(self.bins)

    def query(self, ref_id: int, beg: int, end: int) -> List[Tuple[int, int]]:
        """Merged, sorted virtual-offset chunks possibly containing records
        overlapping [beg, end) on ref_id."""
        if not (0 <= ref_id < self.n_ref):
            return []
        bins = self.bins[ref_id]
        linear = self.linear[ref_id]
        min_off = 0
        w = beg >> LINEAR_SHIFT
        if linear:
            min_off = linear[min(w, len(linear) - 1)]
        chunks = [
            (cb, ce)
            for b in reg2bins(beg, end)
            for cb, ce in bins.get(b, ())
            if ce > min_off
        ]
        chunks.sort()
        merged: List[Tuple[int, int]] = []
        for cb, ce in chunks:
            cb = max(cb, min_off)
            if merged and cb <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
            else:
                merged.append((cb, ce))
        return merged


def read_bai(path: str | Path) -> BaiIndex:
    data = Path(path).read_bytes()
    if data[:4] != BAI_MAGIC:
        raise ValueError(f"{path}: not a BAI file (bad magic)")
    off = 4
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    bins: List[Dict[int, List[Tuple[int, int]]]] = []
    linear: List[List[int]] = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bmap: Dict[int, List[Tuple[int, int]]] = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                cb, ce = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((cb, ce))
            if b != PSEUDO_BIN:
                bmap[b] = chunks
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        ioffs = list(struct.unpack_from(f"<{n_intv}Q", data, off))
        off += 8 * n_intv
        bins.append(bmap)
        linear.append(ioffs)
    return BaiIndex(bins, linear)


def build_bai(
    n_ref: int,
    records: List[Tuple[int, int, int, int, int]],
) -> BaiIndex:
    """Build an index from (ref_id, pos, end_pos, voffset_start,
    voffset_end) per mapped record, in file order."""
    bins: List[Dict[int, List[Tuple[int, int]]]] = [dict() for _ in range(n_ref)]
    linear: List[Dict[int, int]] = [dict() for _ in range(n_ref)]
    for rid, pos, end, vbeg, vend in records:
        if rid < 0 or rid >= n_ref:
            continue
        end = max(end, pos + 1)
        if end > (1 << 29):
            # BAI's 5-level binning tops out at 2^29; a silent build here
            # would misplace every record past it. htslib switches to CSI
            # (io.csi / write_bam(index="csi") — auto-picked by
            # write_bam(index=True) on long references).
            raise ValueError(
                f"position {end} exceeds BAI's 2^29 limit; use a CSI index"
            )
        b = reg2bin(pos, end)
        chunks = bins[rid].setdefault(b, [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1] = (chunks[-1][0], vend)
        else:
            chunks.append((vbeg, vend))
        for w in range(pos >> LINEAR_SHIFT, ((end - 1) >> LINEAR_SHIFT) + 1):
            prev = linear[rid].get(w)
            if prev is None or vbeg < prev:
                linear[rid][w] = vbeg
    lin_lists: List[List[int]] = []
    for lmap in linear:
        if not lmap:
            lin_lists.append([])
            continue
        n = max(lmap) + 1
        out = [0] * n
        last = 0
        for w in range(n):
            if w in lmap:
                last = lmap[w]
            out[w] = last or lmap.get(w, last)
        # fill leading zeros with the first known offset (htslib fills
        # gaps with the previous window's offset; leading windows get the
        # first record's)
        first = next((lmap[w] for w in sorted(lmap)), 0)
        for w in range(n):
            if out[w] == 0:
                out[w] = first
            else:
                break
        lin_lists.append(out)
    return BaiIndex(bins, lin_lists)


def write_bai(path: str | Path, index: BaiIndex) -> None:
    out = bytearray(BAI_MAGIC)
    out += struct.pack("<i", index.n_ref)
    for bmap, lin in zip(index.bins, index.linear):
        out += struct.pack("<i", len(bmap))
        for b in sorted(bmap):
            chunks = bmap[b]
            out += struct.pack("<Ii", b, len(chunks))
            for cb, ce in chunks:
                out += struct.pack("<QQ", cb, ce)
        out += struct.pack("<i", len(lin))
        for v in lin:
            out += struct.pack("<Q", v)
    Path(path).write_bytes(bytes(out))
