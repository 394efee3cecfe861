"""CSI (coordinate-sorted index) v1 reading, writing, building — first
party. Completes the htslib-index family next to io.bai (ROADMAP:
BAI/CSI support; the reference gets this via pysam/htslib, SURVEY.md §2
#6 / §2a samtools row).

CSI generalizes BAI (SAM spec v1.6 §5.3 extension / CSIv1 spec): the
R-tree gets a configurable leaf width (``min_shift``, default 14 = 16 kb)
and depth (default 5), so references longer than 2^29 (BAI's limit) can
be indexed. There is no linear index; instead every bin carries
``loffset`` — the virtual file offset of the first record overlapping
the bin's interval — used to prune chunks. The on-disk container is
BGZF-compressed (unlike raw BAI).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, List, Tuple

CSI_MAGIC = b"CSI\x01"


def reg2bin(beg: int, end: int, min_shift: int = 14, depth: int = 5) -> int:
    """Smallest bin containing [beg, end) (htslib hts_reg2bin)."""
    end -= 1
    s = min_shift
    t = ((1 << (3 * depth)) - 1) // 7
    for level in range(depth, 0, -1):
        if beg >> s == end >> s:
            return t + (beg >> s)
        s += 3
        t -= 1 << (3 * (level - 1))
    return 0


def reg2bins(beg: int, end: int, min_shift: int = 14, depth: int = 5) -> List[int]:
    """All bins that may contain records overlapping [beg, end)
    (htslib hts_reg2bins)."""
    end -= 1
    bins: List[int] = []
    s = min_shift + 3 * depth
    t = 0
    for level in range(depth + 1):
        bins.extend(range(t + (beg >> s), t + (end >> s) + 1))
        t += 1 << (3 * level)
        s -= 3
    return bins


class CsiIndex:
    """Parsed index: per reference, bin -> (loffset, chunk list)."""

    def __init__(
        self,
        bins: List[Dict[int, Tuple[int, List[Tuple[int, int]]]]],
        min_shift: int = 14,
        depth: int = 5,
        aux: bytes = b"",
    ):
        self.bins = bins
        self.min_shift = min_shift
        self.depth = depth
        self.aux = aux

    @property
    def n_ref(self) -> int:
        return len(self.bins)

    def _min_offset(self, bmap, beg: int) -> int:
        """loffset of the exact LEAF bin containing ``beg`` (0 — no
        pruning — when absent). Sound because build_csi sets every leaf's
        loffset to the min voffset among records OVERLAPPING that window,
        and in a coordinate-sorted BAM any record overlapping a query
        starting in that window has voffset >= that minimum. Walking up
        to ancestor bins is NOT sound with assignment-based ancestor
        loffsets: an ancestor's first assigned record can sit far right
        of the query and prune a left-of-it overlapping record (found by
        review repro)."""
        leaf_base = ((1 << (3 * self.depth)) - 1) // 7
        b = leaf_base + (beg >> self.min_shift)
        return bmap[b][0] if b in bmap else 0

    def query(self, ref_id: int, beg: int, end: int) -> List[Tuple[int, int]]:
        """Merged, sorted virtual-offset chunks possibly containing records
        overlapping [beg, end) on ref_id (same contract as BaiIndex.query)."""
        if not (0 <= ref_id < self.n_ref):
            return []
        bmap = self.bins[ref_id]
        min_off = self._min_offset(bmap, beg)
        chunks = [
            (cb, ce)
            for b in reg2bins(beg, end, self.min_shift, self.depth)
            if b in bmap
            for cb, ce in bmap[b][1]
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


def read_csi(path: str | Path) -> CsiIndex:
    raw = Path(path).read_bytes()
    # BGZF container: concatenated gzip members (same framing as BAM);
    # zlib stops at each member boundary, so walk unused_data
    out = []
    rest = raw
    while rest:
        d = zlib.decompressobj(wbits=zlib.MAX_WBITS | 32)
        out.append(d.decompress(rest))
        rest = d.unused_data
    data = b"".join(out)
    if data[:4] != CSI_MAGIC:
        raise ValueError(f"{path}: not a CSI file (bad magic)")
    off = 4
    min_shift, depth, l_aux = struct.unpack_from("<iii", data, off)
    off += 12
    aux = data[off : off + l_aux]
    off += l_aux
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    bins: List[Dict[int, Tuple[int, List[Tuple[int, int]]]]] = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bmap: Dict[int, Tuple[int, List[Tuple[int, int]]]] = {}
        for _ in range(n_bin):
            b, loffset, n_chunk = struct.unpack_from("<IQi", data, off)
            off += 16
            chunks = []
            for _ in range(n_chunk):
                cb, ce = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((cb, ce))
            bmap[b] = (loffset, chunks)
        bins.append(bmap)
    return CsiIndex(bins, min_shift, depth, aux)


def write_csi(path: str | Path, index: CsiIndex) -> None:
    from breakmer_tpu_torch.io.bam import _bgzf_compress

    out = bytearray(CSI_MAGIC)
    out += struct.pack("<iii", index.min_shift, index.depth, len(index.aux))
    out += index.aux
    out += struct.pack("<i", index.n_ref)
    for bmap in index.bins:
        out += struct.pack("<i", len(bmap))
        for b in sorted(bmap):
            loffset, chunks = bmap[b]
            out += struct.pack("<IQi", b, loffset, len(chunks))
            for cb, ce in chunks:
                out += struct.pack("<QQ", cb, ce)
    Path(path).write_bytes(_bgzf_compress(bytes(out)))


def build_csi(
    n_ref: int,
    records: List[Tuple[int, int, int, int, int]],
    min_shift: int = 14,
    depth: int = 5,
) -> CsiIndex:
    """Build an index from (ref_id, pos, end_pos, voffset_start,
    voffset_end) per mapped record, in file order (same input contract as
    io.bai.build_bai)."""
    bins: List[Dict[int, Tuple[int, List[Tuple[int, int]]]]] = [
        dict() for _ in range(n_ref)
    ]
    leaf_base = ((1 << (3 * depth)) - 1) // 7
    for rid, pos, end, vbeg, vend in records:
        if rid < 0 or rid >= n_ref:
            continue
        end = max(end, pos + 1)
        b = reg2bin(pos, end, min_shift, depth)
        loffset, chunks = bins[rid].get(b, (vbeg, []))
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1] = (chunks[-1][0], vend)
        else:
            chunks.append((vbeg, vend))
        bins[rid][b] = (min(loffset, vbeg), chunks)
        # loffset of every LEAF bin the record overlaps: first overlapping
        # record's virtual offset (the linear-index replacement)
        for w in range(pos >> min_shift, ((end - 1) >> min_shift) + 1):
            lb = leaf_base + w
            if lb in bins[rid]:
                lo, ch = bins[rid][lb]
                bins[rid][lb] = (min(lo, vbeg), ch)
            else:
                bins[rid][lb] = (vbeg, [])
    # drop empty leaf bins whose loffset duplicates pruning info? htslib
    # keeps loffset-only bins out of the bin table and fills loffsets on
    # the fly; keeping them (with zero chunks) is spec-legal and keeps
    # build simple — readers treat n_chunk==0 bins as loffset carriers.
    return CsiIndex(bins, min_shift, depth)
