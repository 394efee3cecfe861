"""Sample-only k-mers of one region, in numpy: every valid k-mer of the
sample's reads (forward strand as stored) counted, less those present on
either strand of the region's reference or among the normal's k-mers,
kept where the count reaches ``min_count``, ordered by count (descending)
then code (ascending). A window is valid where it lies inside its read
and holds no N; a k-mer's code is its bases at two bits each (A, C, G, T
= 0..3), the first base in the high bits."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def kmer_codes(codes: np.ndarray, lengths: np.ndarray, k: int) -> np.ndarray:
    """Codes of the valid windows of rows ``codes[i, :lengths[i]]``."""
    codes = np.asarray(codes).astype(np.int64)
    if codes.ndim == 1:
        codes = codes[None, :]
    lengths = np.asarray(lengths, dtype=np.int64).reshape(-1)
    R, L = codes.shape
    W = L - k + 1
    if W <= 0 or R == 0:
        return np.zeros(0, dtype=np.int64)
    acc = np.zeros((R, W), dtype=np.int64)
    bad = np.zeros((R, W), dtype=bool)
    for j in range(k):
        win = codes[:, j:j + W]
        bad |= (win < 0) | (win > 3)
        acc = (acc << 2) | np.where(bad, 0, win)
    valid = ~bad & (np.arange(W)[None, :] <= lengths[:, None] - k)
    return acc[valid]


def revcomp(kmers: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros_like(kmers)
    c = kmers.copy()
    for _ in range(k):
        out = (out << 2) | (3 - (c & 3))
        c >>= 2
    return out


def sample_only(sample_codes, sample_lengths, ref_codes, k: int,
                normal_codes: Optional[np.ndarray] = None,
                normal_lengths: Optional[np.ndarray] = None, min_count: int = 2,
                table_bits: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(values, counts). ``table_bits`` holds the reference and normal
    tables at that many low bits of a code: the lower-precision control."""
    s = kmer_codes(sample_codes, sample_lengths, k)
    values, counts = np.unique(s, return_counts=True)
    r = kmer_codes(np.asarray(ref_codes).reshape(1, -1), [np.asarray(ref_codes).size], k)
    table = np.concatenate([r, revcomp(r, k)])
    if normal_codes is not None and len(normal_codes):
        table = np.concatenate([table, kmer_codes(normal_codes, normal_lengths, k)])
    probe = values
    if table_bits is not None:
        mask = (1 << table_bits) - 1
        table, probe = table & mask, values & mask
    keep = ~np.isin(probe, table) & (counts >= min_count)
    values, counts = values[keep], counts[keep]
    order = np.lexsort((values, -counts))
    return values[order].astype(np.uint32), counts[order].astype(np.int64)
