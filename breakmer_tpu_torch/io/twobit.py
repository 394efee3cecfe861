"""UCSC .2bit format reader/writer.

The reference builds a genome ``.2bit`` with faToTwoBit and serves it via
gfServer (SURVEY.md §2a). This framework's own artifact is the packed npz
genome index, but users migrating from the reference ecosystem often have
``.2bit`` files — this module reads them directly (and writes them, for
round-trips/fixtures), so ``reference_fasta`` may point at a ``.2bit``.

Format (UCSC spec): little/big-endian u32 signature 0x1A412743, version 0,
sequenceCount, reserved; index of (nameSize u8, name, offset u32); per
record: dnaSize u32, nBlockCount + starts + sizes, maskBlockCount +
starts + sizes, reserved u32, then packed DNA at 2 bits/base with the
FIRST base in the two HIGH bits of each byte and base codes T=0 C=1 A=2
G=3 (note: different from this package's internal A=0 C=1 G=2 T=3).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from breakmer_tpu_torch.encode import encode_seq

SIGNATURE = 0x1A412743

# .2bit 2-bit value -> internal base code: T=0->3, C=1->1, A=2->0, G=3->2
_TWOBIT_TO_CODE = np.array([3, 1, 0, 2], dtype=np.int8)
# internal base code -> .2bit 2-bit value: A->2, C->1, G->3, T->0, N->0(T… masked)
_CODE_TO_TWOBIT = np.array([2, 1, 3, 0, 0], dtype=np.uint8)


class TwoBitReader:
    """Random access over a .2bit file (whole file held in memory —
    a 3Gbp genome is ~800MB packed)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        data = self.path.read_bytes()
        sig_le = struct.unpack_from("<I", data, 0)[0]
        if sig_le == SIGNATURE:
            self._e = "<"
        elif struct.unpack_from(">I", data, 0)[0] == SIGNATURE:
            self._e = ">"
        else:
            raise ValueError(f"{path}: not a .2bit file")
        e = self._e
        version, count, _res = struct.unpack_from(f"{e}III", data, 4)
        if version != 0:
            raise ValueError(f"{path}: unsupported .2bit version {version}")
        off = 16
        self._offsets: Dict[str, int] = {}
        for _ in range(count):
            name_size = data[off]
            name = data[off + 1 : off + 1 + name_size].decode("ascii")
            (rec_off,) = struct.unpack_from(f"{e}I", data, off + 1 + name_size)
            self._offsets[name] = rec_off
            off += 1 + name_size + 4
        self._data = data
        self._parsed: Dict[str, tuple] = {}

    @property
    def names(self) -> List[str]:
        return list(self._offsets)

    def _record(self, name: str) -> tuple:
        if name in self._parsed:
            return self._parsed[name]
        e = self._e
        data = self._data
        off = self._offsets[name]
        (dna_size,) = struct.unpack_from(f"{e}I", data, off)
        off += 4
        (n_blocks,) = struct.unpack_from(f"{e}I", data, off)
        off += 4
        n_starts = np.frombuffer(data, dtype=f"{e}u4", count=n_blocks, offset=off)
        off += 4 * n_blocks
        n_sizes = np.frombuffer(data, dtype=f"{e}u4", count=n_blocks, offset=off)
        off += 4 * n_blocks
        (m_blocks,) = struct.unpack_from(f"{e}I", data, off)
        off += 4 + 8 * m_blocks  # skip mask blocks (soft-mask ignored)
        off += 4  # reserved
        rec = (dna_size, n_starts, n_sizes, off)
        self._parsed[name] = rec
        return rec

    def length(self, name: str) -> int:
        return int(self._record(name)[0])

    def fetch_codes(self, name: str, start: int, end: int) -> np.ndarray:
        dna_size, n_starts, n_sizes, dna_off = self._record(name)
        start = max(0, start)
        end = min(int(dna_size), end)
        if end <= start:
            return np.empty(0, dtype=np.int8)
        byte_lo = start // 4
        byte_hi = (end + 3) // 4
        raw = np.frombuffer(
            self._data, dtype=np.uint8, count=byte_hi - byte_lo,
            offset=dna_off + byte_lo,
        )
        # unpack MSB-first 2-bit fields
        shifts = np.array([6, 4, 2, 0], dtype=np.uint8)
        vals = ((raw[:, None] >> shifts[None, :]) & 3).reshape(-1)
        codes = _TWOBIT_TO_CODE[vals[start - byte_lo * 4 : start - byte_lo * 4 + (end - start)]]
        codes = codes.copy()
        # apply N blocks
        for bs, bl in zip(n_starts, n_sizes):
            lo = max(start, int(bs))
            hi = min(end, int(bs) + int(bl))
            if hi > lo:
                codes[lo - start : hi - start] = 4
        return codes

    def fetch(self, name: str, start: int, end: int) -> str:
        from breakmer_tpu_torch.encode import decode_seq

        return decode_seq(self.fetch_codes(name, start, end))

    def to_dict(self) -> Dict[str, str]:
        return {n: self.fetch(n, 0, self.length(n)) for n in self.names}


def write_2bit(path: str | Path, seqs: Dict[str, str]) -> None:
    """faToTwoBit replacement: write sequences (N runs become N blocks)."""
    out = bytearray()
    out += struct.pack("<IIII", SIGNATURE, 0, len(seqs), 0)
    index_pos = len(out)
    for name in seqs:
        out += bytes([len(name)]) + name.encode("ascii") + b"\x00\x00\x00\x00"
    records: List[Tuple[str, int]] = []
    for name, seq in seqs.items():
        records.append((name, len(out)))
        codes = encode_seq(seq)
        n = len(codes)
        is_n = codes >= 4
        # run-length N blocks
        starts, sizes = [], []
        i = 0
        idx = np.nonzero(is_n)[0]
        if len(idx):
            run_start = idx[0]
            prev = idx[0]
            for p in idx[1:]:
                if p != prev + 1:
                    starts.append(run_start)
                    sizes.append(prev - run_start + 1)
                    run_start = p
                prev = p
            starts.append(run_start)
            sizes.append(prev - run_start + 1)
        out += struct.pack("<I", n)
        out += struct.pack("<I", len(starts))
        out += np.array(starts, dtype="<u4").tobytes()
        out += np.array(sizes, dtype="<u4").tobytes()
        out += struct.pack("<I", 0)  # no mask blocks
        out += struct.pack("<I", 0)  # reserved
        vals = _CODE_TO_TWOBIT[codes]
        pad = (-n) % 4
        if pad:
            vals = np.concatenate([vals, np.zeros(pad, dtype=np.uint8)])
        vals = vals.reshape(-1, 4)
        packed = (
            (vals[:, 0] << 6) | (vals[:, 1] << 4) | (vals[:, 2] << 2) | vals[:, 3]
        ).astype(np.uint8)
        out += packed.tobytes()
    # back-fill index offsets
    pos = index_pos
    for name, rec_off in records:
        pos += 1 + len(name)
        struct.pack_into("<I", out, pos, rec_off)
        pos += 4
    Path(path).write_bytes(bytes(out))
