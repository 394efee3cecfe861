"""A region's BAM records as columns, through the file's index.

``BamIndexedReader.fetch`` (io/bam.py) inflates a region's chunks block by
block and parses each record in Python. ``BamColumnReader.fetch_columns``
serves the same records from the same chunks as the arrays of the native
columnar decode (``native.bam_decode_columns``, the tumour's whole-file
path): each chunk read with one ``os.pread``, inflated in one native call,
cut at the chunk's end and decoded natively, then ``fetch``'s overlap rule
applied as a mask. Memory stays bounded by a region's chunks.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

import numpy as np

from breakmer_tpu_torch.io.bam import BamIndexedReader
from breakmer_tpu_torch.io.sam import FLAG_UNMAPPED

BGZF_MAX_BLOCK = 1 << 16  # a BGZF member's largest compressed size
# the per-record columns of native.bam_decode_columns; the 2-D ones with
# the value that pads a row past its record
ROW_COLUMNS = (
    "refid", "pos", "mapq", "flag", "next_refid", "next_pos", "tlen", "lseq",
    "n_cigar", "clip_left", "clip_right", "ref_span",
    "seq_codes", "quals", "names", "cigar_ops",
)
_ROW_PAD = {"seq_codes": 4, "quals": -1, "names": 0, "cigar_ops": 0}


class BamColumnReader(BamIndexedReader):
    """An indexed BAM reader that also yields a region's records as
    columns. Reads the file with ``os.pread`` (no shared seek position),
    so threads may share one for ``fetch_columns``."""

    def fetch_columns(self, chrom: str, start: int, end: int) -> Optional[dict]:
        """The records ``fetch`` yields, in its order, as the columns of
        ``native.bam_decode_columns`` (``n`` and ``ROW_COLUMNS``), plus
        ``decoded``: the records decoded before the overlap rule. None
        without the native library."""
        from breakmer_tpu_torch import native

        if not native.available():
            return None
        rid = self._ref_id(chrom)
        parts, decoded = [], 0
        for vbeg, vend in self.index.query(rid, start, end) if rid >= 0 else ():
            cols = self._decode_chunk(vbeg, vend)
            if cols is None:
                return None
            if cols["n"]:
                decoded += cols["n"]
                keep = _overlapping_rows(cols, rid, start, end)
                parts.append({k: cols[k][keep] for k in ROW_COLUMNS})
        out = _concat_rows(parts)
        out["decoded"] = decoded
        return out

    def _decode_chunk(self, vbeg: int, vend: int) -> Optional[dict]:
        """Columns of the records that start in [vbeg, vend): the chunk's
        blocks read in one ``pread``, inflated in one native call and cut at
        ``vend``, so no record past the chunk's end reaches the decoder."""
        from breakmer_tpu_torch import native

        if vend <= vbeg:
            return {"n": 0}
        cbeg, cend, uend = vbeg >> 16, vend >> 16, vend & 0xFFFF
        tail = cend - cbeg  # compressed bytes before vend's block
        raw = os.pread(self._fh.fileno(), tail + (BGZF_MAX_BLOCK if uend else 0), cbeg)
        last_isize = 0
        if uend:  # vend lies inside a block: take that block whole
            bsize = _bgzf_block_size(raw, tail)
            if bsize:
                raw = raw[: tail + bsize]
                last_isize = struct.unpack_from("<I", raw, tail + bsize - 4)[0]
            else:  # the file ends before vend's block, where fetch stops too
                raw, uend = raw[:tail], 0
        data = native.bgzf_inflate(raw)
        if data is None:
            return None
        cut = len(data) - last_isize + min(uend, last_isize)
        return native.bam_decode_columns(data[:cut], vbeg & 0xFFFF)


def _bgzf_block_size(buf: bytes, off: int) -> int:
    """Compressed size of the BGZF member at ``buf[off:]`` (its BC
    subfield), or 0 where no whole member lies there."""
    if len(buf) < off + 12 or buf[off : off + 2] != b"\x1f\x8b":
        return 0
    xlen = struct.unpack_from("<H", buf, off + 10)[0]
    p, xend = off + 12, min(off + 12 + xlen, len(buf))
    while p + 6 <= xend:
        slen = struct.unpack_from("<H", buf, p + 2)[0]
        if buf[p : p + 2] == b"BC" and slen == 2:
            bsize = struct.unpack_from("<H", buf, p + 4)[0] + 1
            return bsize if off + bsize <= len(buf) else 0
        p += 4 + slen
    return 0


def _overlapping_rows(cols: dict, rid: int, start: int, end: int) -> np.ndarray:
    """Rows of a chunk's columns that ``fetch`` yields: on ``rid``,
    placed-unmapped with start <= pos < end or mapped and overlapping
    [start, end), before the first mapped record there at or past ``end``
    (where ``fetch`` stops reading a coordinate-sorted chunk)."""
    pos = cols["pos"].astype(np.int64)
    same = cols["refid"] == rid
    unmapped = (cols["flag"] & FLAG_UNMAPPED) != 0
    keep = same & np.where(
        unmapped, (start <= pos) & (pos < end),
        (pos < end) & (pos + cols["ref_span"] > start),
    )
    past = np.flatnonzero(same & ~unmapped & (pos >= end))
    if len(past):
        keep[past[0]:] = False
    return np.flatnonzero(keep)


def _concat_rows(parts: List[dict]) -> dict:
    """Chunks' kept rows as one set of columns, 2-D columns padded to the
    widest chunk's width."""
    if not parts:
        return {"n": 0}
    if len(parts) == 1:
        return {"n": len(parts[0]["pos"]), **parts[0]}
    out = {"n": sum(len(p["pos"]) for p in parts)}
    for k in ROW_COLUMNS:
        if k not in _ROW_PAD:
            out[k] = np.concatenate([p[k] for p in parts])
            continue
        width = max(p[k].shape[1] for p in parts)
        out[k] = np.concatenate([
            np.pad(p[k], ((0, 0), (0, width - p[k].shape[1])), constant_values=_ROW_PAD[k])
            for p in parts
        ])
    return out


def column_qnames(names: np.ndarray) -> List[str]:
    """Read names from the columns' NUL-padded ``names`` rows."""
    rows = np.ascontiguousarray(names, dtype=np.uint8)
    return [b.decode() for b in rows.view(f"S{rows.shape[1]}")[:, 0].tolist()]
