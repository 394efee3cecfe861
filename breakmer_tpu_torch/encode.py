"""Base encoding and packed sequence containers.

The reference pipeline moves sequence between stages as text files (fastq,
fasta, jellyfish dumps, PSL). Here every sequence becomes a small-integer
tensor once, at ingest, and stays packed for the rest of the pipeline
(SURVEY.md §7 layer 1): base codes A,C,G,T -> 0..3, anything else -> 4
(N / pad sentinel), plus a 2-bit packer for whole-genome storage
(replacing BLAT's faToTwoBit ``.2bit``; reference: sv_caller.py blat setup).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

import numpy as np

# Base codes. 4 is the sentinel for N / padding; kernels mask it out.
BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 0, 1, 2, 3, 4
PAD = BASE_N

_ENCODE_LUT = np.full(256, BASE_N, dtype=np.int8)
for _ch, _code in (("A", BASE_A), ("C", BASE_C), ("G", BASE_G), ("T", BASE_T)):
    _ENCODE_LUT[ord(_ch)] = _code
    _ENCODE_LUT[ord(_ch.lower())] = _code

_DECODE_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement of 0..3 is 3..0; N stays N
_COMP_LUT = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def encode_seq(seq: str | bytes) -> np.ndarray:
    """Encode a DNA string to int8 base codes (A,C,G,T->0..3, else 4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _ENCODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_seq(codes: np.ndarray) -> str:
    """Decode int8 base codes back to an ACGTN string (pads included)."""
    codes = np.asarray(codes)
    return _DECODE_LUT[np.clip(codes, 0, 4)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement in code space."""
    return _COMP_LUT[np.asarray(codes)][::-1].copy()


def revcomp(seq: str) -> str:
    return decode_seq(revcomp_codes(encode_seq(seq)))


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack base codes into uint32 words, 16 bases per word, base 0 in the
    two LSBs. N bases are stored as A (0); callers needing N-awareness keep
    the unpacked mask. This is the first-party replacement for the
    reference's faToTwoBit ``.2bit`` artifact (SURVEY.md §2a)."""
    codes = np.asarray(codes)
    n = len(codes)
    padded = np.zeros((n + 15) // 16 * 16, dtype=np.uint32)
    padded[:n] = np.where(codes[:n] >= 4, 0, codes[:n]).astype(np.uint32)
    padded = padded.reshape(-1, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    return (padded << shifts).sum(axis=1, dtype=np.uint32)


def unpack_2bit(packed: np.ndarray, length: int) -> np.ndarray:
    """Inverse of :func:`pack_2bit` (N-ness is lost; returns 0..3 codes)."""
    packed = np.asarray(packed, dtype=np.uint32)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    codes = ((packed[:, None] >> shifts) & 3).astype(np.int8).reshape(-1)
    return codes[:length]


@dataclasses.dataclass
class ReadBatch:
    """A padded batch of reads, the device-side unit of work.

    Replaces the reference's per-region ``sv_reads fastq`` files
    (reference: sv_processor.py target.extract_bam_reads writes fastq;
    utils.py get_fastq_reads re-parses them). Data stays resident:

      codes   [R, Lmax] int8 base codes, PAD(4) beyond each read's length
      lengths [R] int32
      names   list of R read names (host-side only)
      quals   optional [R, Lmax] int8 phred scores (-1 pad)
    """

    codes: np.ndarray
    lengths: np.ndarray
    names: List[str]
    quals: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.names)

    @property
    def max_len(self) -> int:
        return self.codes.shape[1] if len(self.names) else 0

    def seq(self, i: int) -> str:
        return decode_seq(self.codes[i, : self.lengths[i]])

    @classmethod
    def from_seqs(
        cls,
        seqs: Sequence[str],
        names: Optional[Sequence[str]] = None,
        quals: Optional[Sequence[Sequence[int]]] = None,
        pad_to: Optional[int] = None,
    ) -> "ReadBatch":
        names = list(names) if names is not None else [f"read{i}" for i in range(len(seqs))]
        lengths = np.array([len(s) for s in seqs], dtype=np.int32)
        lmax = int(lengths.max()) if len(seqs) else 0
        if pad_to is not None:
            lmax = max(lmax, pad_to)
        codes = np.full((len(seqs), lmax), PAD, dtype=np.int8)
        for i, s in enumerate(seqs):
            codes[i, : len(s)] = encode_seq(s)
        qarr = None
        if quals is not None:
            qarr = np.full((len(seqs), lmax), -1, dtype=np.int8)
            for i, q in enumerate(quals):
                qarr[i, : len(q)] = np.asarray(q, dtype=np.int8)
        return cls(codes=codes, lengths=lengths, names=names, quals=qarr)

    def subset(self, idx: Iterable[int]) -> "ReadBatch":
        idx = np.asarray(list(idx), dtype=np.int64)
        return ReadBatch(
            codes=self.codes[idx],
            lengths=self.lengths[idx],
            names=[self.names[i] for i in idx],
            quals=self.quals[idx] if self.quals is not None else None,
        )


def pad_tier(length: int, tiers: Sequence[int]) -> int:
    """Smallest tier >= length; bounds recompiles by bucketing dynamic
    shapes into a fixed set of padded sizes (SURVEY.md §7 hard part 3)."""
    for t in tiers:
        if length <= t:
            return t
    # beyond the largest tier: round up to a multiple of the largest
    top = tiers[-1]
    return ((length + top - 1) // top) * top
