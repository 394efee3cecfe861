"""The reference genome and the panel of a configuration.

The genome is uniform random sequence made from a fixed seed, the same
for every run, as a lab's hg19 is. Any slice of it is made on demand, a
block of 2^20 bases at a time, each block from its own seed, so the
generator never holds the whole genome; the first run in a checkout
writes it once as a ``.2bit`` for the program to read. The panel (target
intervals) is fixed by the configuration too; only the samples come from
``--seed``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import struct
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

BLOCK = 1 << 20
# bump when the way the genome is made changes: it names the cache
GENOME_FORMAT = "svbench-genome-v1"


@dataclasses.dataclass(frozen=True)
class GenomeSpec:
    seed: int
    lengths: Tuple[Tuple[str, int], ...]

    @classmethod
    def from_config(cls, g: dict) -> "GenomeSpec":
        total, n = int(g["total_bp"]), int(g["chromosomes"])
        # human-like spread of chromosome sizes: the largest about twice the
        # smallest, summing to total_bp
        weights = np.linspace(2.0, 1.0, n)
        sizes = np.floor(weights / weights.sum() * total).astype(np.int64)
        sizes[0] += total - int(sizes.sum())
        return cls(int(g["seed"]), tuple((f"chr{i + 1}", int(s)) for i, s in enumerate(sizes)))

    @property
    def key(self) -> str:
        blob = json.dumps([GENOME_FORMAT, self.seed, self.lengths]).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


class Genome:
    """Codes (A, C, G, T = 0..3) of any slice of the spec's genome."""

    def __init__(self, spec: GenomeSpec):
        self.spec = spec
        self.lengths: Dict[str, int] = dict(spec.lengths)
        self.names: List[str] = [n for n, _ in spec.lengths]
        self._block = lru_cache(maxsize=64)(self._make_block)

    def _make_block(self, ci: int, b: int) -> np.ndarray:
        rng = np.random.Generator(np.random.PCG64(np.random.SeedSequence([self.spec.seed, ci, b])))
        return rng.integers(0, 4, BLOCK, dtype=np.uint8)

    def fetch(self, chrom: str, start: int, end: int) -> np.ndarray:
        n = self.lengths[chrom]
        start, end = max(0, start), min(n, end)
        if end <= start:
            return np.zeros(0, dtype=np.uint8)
        ci = self.names.index(chrom)
        parts = []
        for b in range(start // BLOCK, (end - 1) // BLOCK + 1):
            blk = self._block(ci, b)
            lo, hi = max(start, b * BLOCK) - b * BLOCK, min(end, (b + 1) * BLOCK) - b * BLOCK
            parts.append(blk[lo:hi])
        return parts[0].copy() if len(parts) == 1 else np.concatenate(parts)

    def iter_blocks(self, chrom: str):
        n = self.lengths[chrom]
        for b in range((n + BLOCK - 1) // BLOCK):
            yield self.fetch(chrom, b * BLOCK, min(n, (b + 1) * BLOCK))


# internal code -> .2bit value (UCSC: T=0 C=1 A=2 G=3)
_TO_TWOBIT = np.array([2, 1, 3, 0], dtype=np.uint8)


def write_2bit(path: Path, genome: Genome) -> None:
    """A .2bit of the genome (no N block, no mask block), streamed a block
    at a time."""
    names = genome.names
    header = struct.pack("<IIII", 0x1A412743, 0, len(names), 0)
    index_len = sum(1 + len(n) + 4 for n in names)
    off = len(header) + index_len
    offsets = []
    for n in names:
        offsets.append(off)
        off += 4 * 4 + (genome.lengths[n] + 3) // 4
    with open(path, "wb") as fh:
        fh.write(header)
        for n, o in zip(names, offsets):
            fh.write(bytes([len(n)]) + n.encode("ascii") + struct.pack("<I", o))
        for n in names:
            fh.write(struct.pack("<IIII", genome.lengths[n], 0, 0, 0))
            for codes in genome.iter_blocks(n):  # every block but the last is a multiple of 4
                v = _TO_TWOBIT[codes]
                pad = (-len(v)) % 4
                if pad:
                    v = np.concatenate([v, np.zeros(pad, dtype=np.uint8)])
                v = v.reshape(-1, 4)
                fh.write(((v[:, 0] << 6) | (v[:, 1] << 4) | (v[:, 2] << 2) | v[:, 3]).astype(np.uint8).tobytes())


@dataclasses.dataclass(frozen=True)
class Target:
    name: str
    chrom: str
    start: int
    end: int


def make_panel(genome: Genome, panel: dict) -> List[Target]:
    """``panel["targets"]`` intervals of ``target_bp`` [lo, hi] bases, on
    chromosomes in proportion to their length, at least ``min_gap`` apart
    and ``edge`` from a chromosome's ends; named ``<prefix><index>``."""
    rng = np.random.default_rng(int(panel["seed"]))
    n = int(panel["targets"])
    lo, hi = panel["target_bp"]
    gap, edge = int(panel["min_gap"]), int(panel["edge"])
    lengths = np.array([genome.lengths[c] for c in genome.names], dtype=np.float64)
    chroms = rng.choice(len(lengths), size=n, p=lengths / lengths.sum())
    out = []
    for ci in range(len(lengths)):
        k = int((chroms == ci).sum())
        if not k:
            continue
        L = int(lengths[ci])
        # k sorted starts with at least gap + hi between neighbours
        room = L - 2 * edge - k * (gap + hi)
        if room <= 0:
            raise ValueError(f"panel: {k} targets do not fit on {genome.names[ci]}")
        starts = np.sort(rng.integers(0, room, k)) + edge + np.arange(k) * (gap + hi)
        sizes = rng.integers(int(lo), int(hi) + 1, k)
        out.extend((genome.names[ci], int(s), int(s + z)) for s, z in zip(starts, sizes))
    prefix = panel["name_prefix"]
    return [Target(f"{prefix}{i:03d}", c, s, e) for i, (c, s, e) in enumerate(out)]


def write_bed(path: Path, targets: List[Target]) -> None:
    path.write_text("".join(f"{t.chrom}\t{t.start}\t{t.end}\t{t.name}\n" for t in targets))
