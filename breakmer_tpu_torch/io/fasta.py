"""FASTA reading/writing and random-access region extraction.

Replaces the reference's samtools-faidx / pysam based region extraction
(reference: utils.py extract_refseq_fa — extracts target region +/- buffer
from reference_fasta and caches it per gene). Here :class:`FastaIndex`
memory-maps nothing exotic: it scans the file once, keeps offsets, and
serves ``fetch(chrom, start, end)`` slices.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np

from breakmer_tpu_torch.encode import encode_seq


def read_fasta(path: str | Path) -> Dict[str, str]:
    """Read a whole (small) FASTA file into {name: sequence}."""
    seqs: Dict[str, List[str]] = {}
    name = None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                name = line[1:].split()[0]
                seqs[name] = []
            elif name is not None:
                seqs[name].append(line)
    return {k: "".join(v) for k, v in seqs.items()}


def write_fasta(path: str | Path, seqs: Dict[str, str], width: int = 60) -> None:
    with open(path, "w") as fh:
        for name, seq in seqs.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")


@dataclasses.dataclass
class _FaiEntry:
    length: int
    offset: int       # file offset of first sequence byte
    line_bases: int   # bases per line
    line_bytes: int   # bytes per line incl. newline


class FastaIndex:
    """faidx-style random access over a FASTA file.

    Builds the index in-process on first use (no external ``samtools faidx``
    subprocess, unlike the reference's utils.py extract_refseq_fa).
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._index: Dict[str, _FaiEntry] = {}
        self._build_index()

    def _build_index(self) -> None:
        with open(self.path, "rb") as fh:
            name = None
            length = 0
            offset = 0
            line_bases = 0
            line_bytes = 0
            first_line = True
            while True:
                pos = fh.tell()
                line = fh.readline()
                if not line:
                    break
                if line.startswith(b">"):
                    if name is not None:
                        self._index[name] = _FaiEntry(length, offset, line_bases, line_bytes)
                    name = line[1:].split()[0].decode("ascii")
                    length = 0
                    first_line = True
                    offset = fh.tell()
                else:
                    stripped = line.rstrip(b"\r\n")
                    if first_line and stripped:
                        line_bases = len(stripped)
                        line_bytes = len(line)
                        first_line = False
                    length += len(stripped)
            if name is not None:
                self._index[name] = _FaiEntry(length, offset, line_bases, line_bytes)

    @property
    def names(self) -> List[str]:
        return list(self._index)

    def length(self, chrom: str) -> int:
        return self._index[chrom].length

    def fetch(self, chrom: str, start: int, end: int) -> str:
        """0-based half-open slice, clamped to the sequence bounds."""
        entry = self._index[chrom]
        start = max(0, start)
        end = min(entry.length, end)
        if end <= start:
            return ""
        with open(self.path, "rb") as fh:
            byte_start = entry.offset + (start // entry.line_bases) * entry.line_bytes + (
                start % entry.line_bases
            )
            # read enough bytes to cover the slice including newlines
            span_lines = (end - 1) // entry.line_bases - start // entry.line_bases
            nbytes = (end - start) + span_lines * (entry.line_bytes - entry.line_bases)
            fh.seek(byte_start)
            raw = fh.read(nbytes)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode("ascii")

    def fetch_codes(self, chrom: str, start: int, end: int) -> np.ndarray:
        return encode_seq(self.fetch(chrom, start, end))

    def iter_chroms(self) -> Iterator[Tuple[str, int]]:
        for name, entry in self._index.items():
            yield name, entry.length

    def to_dict(self) -> Dict[str, str]:
        return {n: self.fetch(n, 0, self.length(n)) for n in self.names}
