"""FASTQ reading/writing.

The reference round-trips SV-informative reads through fastq files between
every stage (reference: utils.py get_fastq_reads / fq_read, sv_processor.py
target.extract_bam_reads). Here fastq is an *ingest* format only — reads
become a packed :class:`breakmer_tpu.encode.ReadBatch` immediately.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

from breakmer_tpu_torch.encode import ReadBatch


def read_fastq(path: str | Path) -> ReadBatch:
    # native C++ parse+encode when built (native/breakmer_native.cc);
    # byte-identical to the Python path (tests/test_native.py)
    from breakmer_tpu_torch import native

    data = Path(path).read_bytes()
    out = native.fastq_decode(data)
    if out is not None and out.get("n"):
        names = [
            bytes(row).split(b"\x00")[0].decode() for row in out["names"]
        ]
        return ReadBatch(
            codes=out["codes"], lengths=out["lengths"], names=names,
            quals=out["quals"],
        )
    return _read_fastq_py(path)


def _read_fastq_py(path: str | Path) -> ReadBatch:
    names: List[str] = []
    seqs: List[str] = []
    quals: List[List[int]] = []
    with open(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                break
            seq = fh.readline().strip()
            fh.readline()  # '+'
            qual = fh.readline().strip()
            names.append(header.strip()[1:].split()[0])
            seqs.append(seq)
            quals.append([ord(c) - 33 for c in qual])
    return ReadBatch.from_seqs(seqs, names=names, quals=quals)


def write_fastq(path: str | Path, batch: ReadBatch) -> None:
    with open(path, "w") as fh:
        for i in range(len(batch)):
            length = int(batch.lengths[i])
            seq = batch.seq(i)
            if batch.quals is not None:
                qual = "".join(chr(int(q) + 33) for q in batch.quals[i, :length])
            else:
                qual = "I" * length
            fh.write(f"@{batch.names[i]}\n{seq}\n+\n{qual}\n")
