"""BAM/BGZF reading and writing — first party, no htslib.

The environment has no pysam (SURVEY.md §7); the reference's alignment
ingest (pysam fetch in target.extract_bam_reads) is replaced by this
module + io.sam. Scope: whole-file streaming decode of BGZF (multi-member
gzip) and the BAM record layout, yielding the same SamRecord objects the
extractor consumes; a minimal writer for fixtures and intermediates.
Random access IS available: io.bai / io.csi parse the index formats and
BamIndexedReader (below) seeks straight to a region's chunks;
whole-file streaming (read_bam_regions) remains the default for small
panels where one pass beats per-region seeks. A C++ BGZF inflate path
slots in underneath without changing this API (native/).

BAM layout reference: SAM spec v1.6 §4 (magic, reference dictionary, then
per-alignment: block_size, refID, pos, l_read_name, mapq, bin, n_cigar_op,
flag, l_seq, next_refID, next_pos, tlen, name, packed CIGAR, 4-bit seq,
qual).
"""

from __future__ import annotations

import gzip
import struct
import zlib
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from breakmer_tpu_torch.io.sam import SamRecord

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_NIBBLE = "=ACMGRSVTWYHKDBN"
_NIBBLE_OF = {c: i for i, c in enumerate(_SEQ_NIBBLE)}
_OP_OF = {c: i for i, c in enumerate(_CIGAR_OPS)}

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _bgzf_decompress(path: str | Path) -> bytes:
    """BGZF is a series of gzip members. Native zlib path when the C++
    runtime is built (native/breakmer_native.cc); gzip module fallback."""
    raw = Path(path).read_bytes()
    from breakmer_tpu_torch import native

    out = native.bgzf_inflate(raw)
    if out is not None:
        return out
    # the native inflate returns None both when the library is absent and
    # when the stream is corrupt; the gzip fallback is the arbiter either
    # way, with its EOFError/BadGzipFile/zlib errors wrapped so a bad
    # input file fails with the path instead of a bare codec exception
    try:
        return gzip.decompress(raw)
    except (EOFError, OSError, zlib.error) as exc:
        raise ValueError(
            f"{path}: truncated or corrupt BGZF/gzip stream ({exc})"
        ) from exc


BGZF_BLOCK_U = 0xFF00  # uncompressed payload per block when writing


def _bgzf_compress(
    data: bytes, level: int = 6, return_offsets: bool = False
):
    """Write BGZF blocks (<=64KB payload each) with the BC extra field.
    With return_offsets, also return the compressed offset of each block
    (block i holds uncompressed bytes [i*BGZF_BLOCK_U, (i+1)*BGZF_BLOCK_U)),
    which is what virtual-offset computation for the BAI needs."""
    out = bytearray()
    offsets: List[int] = []
    for i in range(0, len(data) or 1, BGZF_BLOCK_U):
        offsets.append(len(out))
        chunk = data[i : i + BGZF_BLOCK_U]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        comp = co.compress(chunk) + co.flush()
        bsize = len(comp) + 25 + 1  # header(12)+extra(6)+deflate+crc(4)+isize(4)
        header = struct.pack(
            "<4BI2BH2BH",
            0x1F, 0x8B, 0x08, 0x04,  # magic, CM=deflate, FLG.FEXTRA
            0,                        # MTIME
            0, 0xFF,                  # XFL, OS
            6,                        # XLEN
            0x42, 0x43,               # 'B','C'
            2,                        # SLEN
        ) + struct.pack("<H", bsize - 1)
        out += header + comp + struct.pack("<II", zlib.crc32(chunk), len(chunk))
    offsets.append(len(out))  # EOF block: voffsets at the file tail land here
    out += BGZF_EOF
    if return_offsets:
        return bytes(out), offsets
    return bytes(out)


def _bgzf_read_block(fh, coffset: int) -> Tuple[bytes, int]:
    """Inflate the single BGZF member at compressed offset ``coffset``;
    returns (uncompressed payload, total compressed size). Empty payload
    with size 0 signals EOF / the empty EOF sentinel block."""
    fh.seek(coffset)
    hdr = fh.read(12)
    if len(hdr) < 12 or hdr[:2] != b"\x1f\x8b":
        return b"", 0
    xlen = struct.unpack_from("<H", hdr, 10)[0]
    extra = fh.read(xlen)
    bsize = None
    p = 0
    while p + 4 <= len(extra):
        si1, si2, slen = extra[p], extra[p + 1], struct.unpack_from("<H", extra, p + 2)[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            bsize = struct.unpack_from("<H", extra, p + 4)[0] + 1
        p += 4 + slen
    if bsize is None:
        raise ValueError("BGZF block missing BC subfield")
    comp_len = bsize - 12 - xlen - 8
    comp = fh.read(comp_len)
    payload = zlib.decompress(comp, -15) if comp_len > 0 else b""
    fh.read(8)  # CRC32 + ISIZE
    return payload, bsize


class BamReader:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        data = _bgzf_decompress(path)
        if data[:4] != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file (bad magic)")
        try:
            l_text = struct.unpack_from("<i", data, 4)[0]
            off = 8 + l_text
            self.header_text = data[8 : 8 + l_text].rstrip(b"\x00").decode()
            n_ref = struct.unpack_from("<i", data, off)[0]
            off += 4
            self.refs: List[Tuple[str, int]] = []
            for _ in range(n_ref):
                l_name = struct.unpack_from("<i", data, off)[0]
                name = data[off + 4 : off + 4 + l_name - 1].decode()
                l_ref = struct.unpack_from("<i", data, off + 4 + l_name)[0]
                self.refs.append((name, l_ref))
                off += 8 + l_name
        except struct.error as exc:
            raise ValueError(f"{path}: truncated BAM header") from exc
        self._data = data
        self._align_off = off

    def _ref_name(self, rid: int) -> str:
        return self.refs[rid][0] if 0 <= rid < len(self.refs) else "*"

    def __iter__(self) -> Iterator[SamRecord]:
        data = self._data
        off = self._align_off
        n = len(data)
        while off + 4 <= n:
            block_size = struct.unpack_from("<i", data, off)[0]
            # 32 bytes is the fixed prefix of a BAM record; a smaller (or
            # negative) block_size is corruption and would otherwise spin
            # this loop forever (off += 4 + block_size can stop advancing)
            if block_size < 32 or off + 4 + block_size > n:
                raise ValueError(
                    f"{self.path}: truncated or corrupt BAM record at "
                    f"uncompressed offset {off}"
                )
            rec = _parse_record(data, off + 4, self._ref_name)
            off += 4 + block_size
            yield rec


def _parse_record(data, off: int, ref_name) -> SamRecord:
    """Decode one BAM alignment record starting at its refID field."""
    (
        ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
        next_ref, next_pos, tlen,
    ) = struct.unpack_from("<iiBBHHHiiii", data, off)
    p = off + 32
    qname = data[p : p + l_read_name - 1].decode()
    p += l_read_name
    cigar = []
    for _ in range(n_cigar):
        v = struct.unpack_from("<I", data, p)[0]
        cigar.append((v >> 4, _CIGAR_OPS[v & 0xF]))
        p += 4
    nb = (l_seq + 1) // 2
    seq_chars = []
    for i in range(l_seq):
        byte = data[p + i // 2]
        nib = (byte >> 4) if i % 2 == 0 else (byte & 0xF)
        seq_chars.append(_SEQ_NIBBLE[nib])
    seq = "".join(seq_chars)
    p += nb
    qual_raw = data[p : p + l_seq]
    qual = [] if (l_seq == 0 or qual_raw[:1] == b"\xff") else list(qual_raw)
    return SamRecord(
        qname=qname,
        flag=flag,
        rname=ref_name(ref_id),
        pos=pos,
        mapq=mapq,
        cigar=cigar,
        rnext=ref_name(next_ref) if next_ref != ref_id or next_ref < 0
        else ref_name(ref_id),
        pnext=next_pos,
        tlen=tlen,
        seq=seq if l_seq else "*",
        qual=qual,
    )


class BamIndexedReader:
    """Random-access BAM reader driven by a BAI or CSI index: only the
    BGZF blocks the index's chunks point at are inflated, so per-region
    cost is independent of file size (the htslib/pysam fetch analog;
    reference: target.extract_bam_reads)."""

    def __init__(self, path: str | Path, bai_path: Optional[str | Path] = None):
        self.path = Path(path)
        self._fh = open(self.path, "rb")
        if bai_path is None:
            bai_path = find_index(path)
            if bai_path is None:
                raise FileNotFoundError(f"no .bai/.csi index next to {path}")
        if str(bai_path).endswith(".csi"):
            from breakmer_tpu_torch.io.csi import read_csi

            self.index = read_csi(bai_path)
        else:
            from breakmer_tpu_torch.io.bai import read_bai

            self.index = read_bai(bai_path)
        self._parse_header()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _inflate_from(self, coffset: int, min_len: int) -> bytes:
        """Inflate consecutive blocks from ``coffset`` until at least
        ``min_len`` uncompressed bytes are available."""
        out = bytearray()
        while len(out) < min_len:
            payload, csize = _bgzf_read_block(self._fh, coffset)
            if csize == 0:
                break
            out += payload
            coffset += csize
        return bytes(out)

    def _parse_header(self) -> None:
        # header may span blocks: inflate until the ref dictionary parses
        need = 1 << 16
        while True:
            data = self._inflate_from(0, need)
            try:
                if data[:4] != b"BAM\x01":
                    raise ValueError(f"{self.path}: not a BAM file (bad magic)")
                l_text = struct.unpack_from("<i", data, 4)[0]
                off = 8 + l_text
                self.header_text = data[8 : 8 + l_text].rstrip(b"\x00").decode()
                n_ref = struct.unpack_from("<i", data, off)[0]
                off += 4
                self.refs: List[Tuple[str, int]] = []
                for _ in range(n_ref):
                    l_name = struct.unpack_from("<i", data, off)[0]
                    name = data[off + 4 : off + 4 + l_name - 1].decode()
                    l_ref = struct.unpack_from("<i", data, off + 4 + l_name)[0]
                    self.refs.append((name, l_ref))
                    off += 8 + l_name
                return
            except struct.error:
                if len(data) < need:  # file exhausted: genuinely corrupt
                    raise ValueError(f"{self.path}: truncated BAM header")
                need *= 2

    def _ref_name(self, rid: int) -> str:
        return self.refs[rid][0] if 0 <= rid < len(self.refs) else "*"

    def _ref_id(self, chrom: str) -> int:
        for i, (name, _ln) in enumerate(self.refs):
            if name == chrom:
                return i
        return -1

    def fetch(self, chrom: str, start: int, end: int) -> Iterator[SamRecord]:
        """Yield records overlapping [start, end) on chrom (mapped overlap
        or placed-unmapped pos within), in file order."""
        rid = self._ref_id(chrom)
        if rid < 0:
            return
        for vbeg, vend in self.index.query(rid, start, end):
            yield from self._scan_chunk(vbeg, vend, chrom, start, end)

    def _scan_chunk(
        self, vbeg: int, vend: int, chrom: str, start: int, end: int
    ) -> Iterator[SamRecord]:
        coffset = vbeg >> 16
        upos = vbeg & 0xFFFF
        buf = bytearray()
        # boundaries[i] = (uncompressed start of block i in buf, its coffset)
        boundaries: List[Tuple[int, int]] = []
        next_coffset = coffset
        exhausted = False

        def ensure(n: int) -> bool:
            nonlocal next_coffset, exhausted
            while len(buf) < n and not exhausted:
                payload, csize = _bgzf_read_block(self._fh, next_coffset)
                if csize == 0:
                    exhausted = True
                    break
                boundaries.append((len(buf), next_coffset))
                buf.extend(payload)
                next_coffset += csize
            return len(buf) >= n

        def voffset(bufpos: int) -> int:
            import bisect

            i = bisect.bisect_right(boundaries, (bufpos, float("inf"))) - 1
            ustart, coff = boundaries[i]
            return (coff << 16) | (bufpos - ustart)

        pos = upos
        while True:
            if not ensure(pos + 4):
                return
            if voffset(pos) >= vend:
                return
            block_size = struct.unpack_from("<i", buf, pos)[0]
            if not ensure(pos + 4 + block_size):
                return
            rec = _parse_record(buf, pos + 4, self._ref_name)
            pos += 4 + block_size
            if rec.rname != chrom:
                continue
            if rec.is_unmapped:
                if start <= rec.pos < end:
                    yield rec
                continue
            if rec.pos >= end:
                return  # coordinate-sorted: nothing later can overlap
            if rec.reference_end() > start:
                yield rec


def stream_bam_records(path: str | Path) -> Iterator[SamRecord]:
    """Whole-file BAM scan with BOUNDED memory: BGZF blocks are inflated
    one at a time into a rolling buffer that is trimmed as records are
    consumed, so peak RSS is O(64 KiB blocks + one record), independent
    of file size — unlike BamReader, which holds the full inflated
    stream (the native columnar path needs that; a plain scan doesn't).
    Yields records identical to ``iter(BamReader(path))``."""
    with open(path, "rb") as fh:
        coffset = 0
        buf = bytearray()
        pos = 0

        def ensure(n: int) -> bool:
            nonlocal coffset
            while len(buf) - pos < n:
                payload, csize = _bgzf_read_block(fh, coffset)
                if csize == 0:
                    return False
                coffset += csize
                buf.extend(payload)
            return True

        if not ensure(8) or bytes(buf[:4]) != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file (bad magic)")
        l_text = struct.unpack_from("<i", buf, 4)[0]
        if not ensure(8 + l_text + 4):
            raise ValueError(f"{path}: truncated BAM header")
        pos = 8 + l_text
        n_ref = struct.unpack_from("<i", buf, pos)[0]
        pos += 4
        refs: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            if not ensure(4):
                raise ValueError(f"{path}: truncated reference dictionary")
            l_name = struct.unpack_from("<i", buf, pos)[0]
            if not ensure(8 + l_name):
                raise ValueError(f"{path}: truncated reference dictionary")
            name = bytes(buf[pos + 4 : pos + 4 + l_name - 1]).decode()
            l_ref = struct.unpack_from("<i", buf, pos + 4 + l_name)[0]
            refs.append((name, l_ref))
            pos += 8 + l_name

        def ref_name(rid: int) -> str:
            return refs[rid][0] if 0 <= rid < len(refs) else "*"

        while ensure(4):
            block_size = struct.unpack_from("<i", buf, pos)[0]
            if block_size < 32:  # see BamReader.__iter__: corrupt size
                raise ValueError(
                    f"{path}: truncated or corrupt BAM record"
                )
            if not ensure(4 + block_size):
                # trailing partial record: raise like BamReader (the two
                # ingest paths are identity-tested against each other)
                raise ValueError(
                    f"{path}: truncated or corrupt BAM record"
                )
            yield _parse_record(buf, pos + 4, ref_name)
            pos += 4 + block_size
            if pos >= (1 << 20):  # trim consumed bytes; keeps buf ~1-2 MiB
                del buf[:pos]
                pos = 0


def find_index(path: str | Path) -> Optional[str]:
    """Sidecar index for a BAM, htslib lookup order: .bai then .csi."""
    for ext in (".bai", ".csi"):
        cand = str(path) + ext
        if Path(cand).exists():
            return cand
    return None


def read_bam(
    path: str | Path, region: Optional[Tuple[str, int, int]] = None
) -> Iterator[SamRecord]:
    """Iterate BAM records, optionally restricted to a region. With a
    sidecar ``.bai``/``.csi`` present, region reads seek straight to the
    indexed chunks (io.bai / io.csi) instead of decoding the whole file."""
    if region is not None and find_index(path) is not None:
        with BamIndexedReader(path) as reader:
            yield from reader.fetch(*region)
        return
    if region is None:
        # bounded-memory scan: no reason to hold the full inflated stream
        yield from stream_bam_records(path)
        return
    for rec in BamReader(path):
        if region is not None:
            chrom, start, end = region
            if rec.is_unmapped:
                if rec.rname != chrom or not (start <= rec.pos < end):
                    continue
            else:
                if rec.rname != chrom:
                    continue
                if rec.reference_end() <= start or rec.pos >= end:
                    continue
        yield rec


def read_alignments(
    path: str | Path, region: Optional[Tuple[str, int, int]] = None
) -> Iterator[SamRecord]:
    """Dispatch on extension: .bam -> BAM, anything else -> SAM text."""
    from breakmer_tpu_torch.io.sam import read_sam

    if str(path).endswith(".bam"):
        return read_bam(path, region)
    return read_sam(path, region)


_NIBBLE_LUT = None


def _pack_nibbles(seq: str) -> bytes:
    """4-bit-pack a read sequence (SAM spec §4.2.3), vectorized: the
    per-base python loop dominated write_bam at deep-coverage fixture
    scale (tools/bench_bounded_ingest.py writes ~1 GB bodies). Unknown
    characters map to N (15), matching the old _NIBBLE_OF.get(..., 15)."""
    global _NIBBLE_LUT
    if not seq:
        return b""
    import numpy as np

    if _NIBBLE_LUT is None:
        lut = np.full(256, 15, dtype=np.uint8)
        for ch, v in _NIBBLE_OF.items():
            lut[ord(ch)] = v
            lut[ord(ch.lower())] = v
        _NIBBLE_LUT = lut
    codes = _NIBBLE_LUT[np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)]
    if len(codes) % 2:
        codes = np.concatenate([codes, np.zeros(1, dtype=np.uint8)])
    return ((codes[0::2] << 4) | codes[1::2]).tobytes()


def write_bam(
    path: str | Path,
    refs: List[Tuple[str, int]],
    records: List[SamRecord],
    index: bool | str = False,
) -> None:
    """Minimal BAM writer (fixtures, intermediates). With ``index=True``
    (or ``"bai"``/``"csi"``) the records must be coordinate-sorted and a
    sidecar index is written alongside (the `samtools index` analog;
    io.bai / io.csi). ``index=True`` picks the format the way samtools
    does: CSI when any reference exceeds BAI's 2^29 coordinate ceiling,
    BAI otherwise."""
    if index is True and any(ln > (1 << 29) for _n, ln in refs):
        index = "csi"
    rid: Dict[str, int] = {name: i for i, (name, _) in enumerate(refs)}
    if index:
        keyed = [
            (rid.get(r.rname, -1), r.pos) for r in records
            if rid.get(r.rname, -1) >= 0
        ]
        if keyed != sorted(keyed):
            raise ValueError(
                "write_bam(index=True) requires coordinate-sorted records"
            )
    rec_offsets: List[int] = []  # flat uncompressed start of each record
    header_text = "".join(
        f"@SQ\tSN:{name}\tLN:{ln}\n" for name, ln in refs
    ).encode()
    body = bytearray()
    body += b"BAM\x01"
    body += struct.pack("<i", len(header_text)) + header_text
    body += struct.pack("<i", len(refs))
    for name, ln in refs:
        bname = name.encode() + b"\x00"
        body += struct.pack("<i", len(bname)) + bname + struct.pack("<i", ln)
    for rec in records:
        rec_offsets.append(len(body))
        name_b = rec.qname.encode() + b"\x00"
        seq = "" if rec.seq == "*" else rec.seq
        l_seq = len(seq)
        cigar_b = b"".join(
            struct.pack("<I", (ln << 4) | _OP_OF[op]) for ln, op in rec.cigar
        )
        seq_b = _pack_nibbles(seq)
        qual_b = bytes(rec.qual) if rec.qual else b"\xff" * l_seq
        rec_b = struct.pack(
            "<iiBBHHHiiii",
            rid.get(rec.rname, -1),
            rec.pos,
            len(name_b),
            rec.mapq,
            0,
            len(rec.cigar),
            rec.flag,
            l_seq,
            rid.get(rec.rnext, -1),
            rec.pnext,
            rec.tlen,
        ) + name_b + cigar_b + bytes(seq_b) + qual_b
        body += struct.pack("<i", len(rec_b)) + rec_b
    rec_offsets.append(len(body))
    if not index:
        Path(path).write_bytes(_bgzf_compress(bytes(body)))
        return
    compressed, block_offsets = _bgzf_compress(bytes(body), return_offsets=True)
    Path(path).write_bytes(compressed)

    def voffset(u: int) -> int:
        return (block_offsets[u // BGZF_BLOCK_U] << 16) | (u % BGZF_BLOCK_U)

    entries = []
    for rec, u0, u1 in zip(records, rec_offsets, rec_offsets[1:]):
        r = rid.get(rec.rname, -1)
        if r < 0:
            continue
        end = rec.pos + 1 if rec.is_unmapped else rec.reference_end()
        entries.append((r, rec.pos, end, voffset(u0), voffset(u1)))
    if index == "csi":
        from breakmer_tpu_torch.io.csi import build_csi, write_csi

        write_csi(str(path) + ".csi", build_csi(len(refs), entries))
    else:
        from breakmer_tpu_torch.io.bai import build_bai, write_bai

        write_bai(str(path) + ".bai", build_bai(len(refs), entries))
