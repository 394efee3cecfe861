"""The germline recheck's junction rule by brute force, in plain numpy (as
the benchmark's other references: none imports torch or the program): does
the matched normal carry an SV's junction?

An event's window is its contig from 2k bases before the junction span
[a, b) to 2k bases after it (k the k-mer size). Every normal read, as stored
and reverse-complemented, is aligned to the window by a full affine-gap local
alignment with traceback (no candidate selection). The read carries the
junction where that alignment

1. holds the span and the k - 1 bases on each side of it in one gapless run
   of aligned columns,
2. holds on each side of the span an exact match of at least k bases, and
3. has matches / columns >= ``identity``, each gap column counted as a
   mismatch.

The alignment: H(i, j) = max(0, H(i-1, j-1) + s, E(i, j), F(i, j)) with E
along the read and F along the window, a gap of g bases costing gap_open +
gap_extend * g, s = match or -mismatch, and a base of code 4 or more scoring
against nothing. The end cell is the best H, the first in the order of i + j
and then of i; the traceback from it takes the diagonal first, then E, then
F, and leaves a gap where it was opened. Scores are integers and no step is a
matrix product. It imports nothing of the program.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

NEG = -(1 << 28)
_LUT = np.full(256, 4, dtype=np.int8)
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _LUT[_c + 32] = _i


def junction_window(contig_seq: str, junction_q: Sequence[int], k: int) -> Tuple[np.ndarray, int, int]:
    """(window codes, a, b): the contig from 2k bases before the span to 2k after it."""
    lo, hi = min(junction_q), max(junction_q)
    q0, q1 = max(0, lo - 2 * k), min(len(contig_seq), hi + 2 * k)
    return _LUT[np.frombuffer(contig_seq[q0:q1].encode(), dtype=np.uint8)], lo - q0, hi - q0


def _revcomp(row: np.ndarray) -> np.ndarray:
    out = row[::-1].copy()
    real = out < 4
    out[real] = 3 - out[real]
    return out


def _fill(q: np.ndarray, t: np.ndarray, params) -> tuple:
    """H, E, F of every pair, [B, Lq + 1, Lt + 1] int32."""
    match, mismatch, gap_open, gap_extend = params
    B, lt = t.shape
    lq = len(q)
    go, ge = gap_open + gap_extend, gap_extend
    H = np.zeros((B, lq + 1, lt + 1), dtype=np.int32)
    E = np.full((B, lq + 1, lt + 1), NEG, dtype=np.int32)
    F = np.full((B, lq + 1, lt + 1), NEG, dtype=np.int32)
    ramp = ge * np.arange(lt, dtype=np.int32)
    t_bad = t >= 4
    for i in range(1, lq + 1):
        F[:, i, 1:] = np.maximum(H[:, i - 1, 1:] - go, F[:, i - 1, 1:] - ge)
        s = np.where(t == q[i - 1], match, -mismatch).astype(np.int32)
        s[t_bad | (q[i - 1] >= 4)] = NEG
        c = np.maximum(np.maximum(H[:, i - 1, :-1] + s, F[:, i, 1:]), 0)
        # E(j) = max over j' < j of c(j') - go - ge (j - 1 - j'): a running maximum
        run = np.maximum.accumulate(c + ramp, axis=1)
        E[:, i, 2:] = run[:, :-1] - go - ramp[:-1]
        H[:, i, 1:] = np.maximum(c, E[:, i, 1:])
    return H, E, F


def _carried(q: np.ndarray, t: np.ndarray, a: int, b: int, k: int, identity: float, params) -> np.ndarray:
    """Rules 1-3 for every pair of the window ``q`` [Lq] and a read ``t`` [B, Lt]."""
    match, mismatch, gap_open, gap_extend = params
    go = gap_open + gap_extend
    B, lt = t.shape
    lq = len(q)
    H, E, F = _fill(q, t, params)
    inner = H[:, 1:, 1:]
    best = inner.reshape(B, -1).max(axis=1)
    ii = np.arange(1, lq + 1).reshape(1, lq, 1)
    jj = np.arange(1, lt + 1).reshape(1, 1, lt)
    order = (ii + jj) * (lq + 2) + ii  # (i + j, i) as one key
    order = np.where(inner == best.reshape(B, 1, 1), order, np.iinfo(np.int64).max)
    cell = order.reshape(B, -1).argmin(axis=1)
    i = cell // lt + 1
    j = cell % lt + 1
    q_end = i.copy()
    stride_i, stride_b = lt + 1, (lq + 1) * (lt + 1)
    Hf, Ef, Ff = H.reshape(-1), E.reshape(-1), F.reshape(-1)
    base = np.arange(B) * stride_b
    qv = q.astype(np.int64)
    tv = t.astype(np.int64)
    rows = np.arange(B)
    state = np.zeros(B, dtype=np.int64)  # 0 H, 1 E, 2 F
    alive = best > 0
    matches, mismatches, gaps = (np.zeros(B, dtype=np.int64) for _ in range(3))
    left_run, left_best, right_run, right_best = (np.zeros(B, dtype=np.int64) for _ in range(4))
    broken = np.zeros(B, dtype=bool)
    lo, hi = a - (k - 1), b + (k - 1)

    def at(m, di, dj):
        return m[np.clip(base + (i + di) * stride_i + (j + dj), 0, None)]

    while alive.any():
        st = state.copy()
        h = at(Hf, 0, 0)
        in_h = alive & (st == 0)
        alive = alive & ~(in_h & (h == 0))
        in_h = in_h & (h != 0)
        qc = qv[np.clip(i - 1, 0, None)]
        tc = tv[rows, np.clip(j - 1, 0, None)]
        s = np.where(qc == tc, match, -mismatch)
        s = np.where((qc >= 4) | (tc >= 4), NEG, s)
        diag = in_h & (h == at(Hf, -1, -1) + s)
        to_e = in_h & ~diag & (h == at(Ef, 0, 0))
        to_f = in_h & ~diag & ~to_e & (h == at(Ff, 0, 0))
        in_e = alive & (st == 1)
        in_f = alive & (st == 2)
        p = i - 1  # the query base an M or I column consumes
        hit = diag & (qc == tc)
        matches += hit
        mismatches += diag & (qc != tc)
        gaps += in_e | in_f
        col = diag | in_e | in_f
        left_run = np.where(hit & (p < a), left_run + 1, np.where(col, 0, left_run))
        right_run = np.where(hit & (p >= b), right_run + 1, np.where(col, 0, right_run))
        left_best = np.maximum(left_best, left_run)
        right_best = np.maximum(right_best, right_run)
        broken |= in_f & (p >= lo) & (p < hi)  # an I column inside the block
        broken |= in_e & (i > lo) & (i < hi)  # a D column between two block bases
        back_e = in_e & (at(Ef, 0, 0) == at(Hf, 0, -1) - go)
        back_f = in_f & (at(Ff, 0, 0) == at(Hf, -1, 0) - go)
        state = np.where(to_e, 1, np.where(to_f, 2, state))
        state = np.where(back_e | back_f, 0, state)
        i = i - (diag | in_f)
        j = j - (diag | in_e)
        alive = alive & (i > 0) & (j > 0)
    cols = matches + mismatches + gaps
    ident = matches / np.maximum(cols, 1)
    return ((best > 0) & (i <= lo) & (q_end >= hi) & ~broken & (left_best >= k) & (right_best >= k)
            & (ident >= identity))


def carriers(window: np.ndarray, a: int, b: int, reads: np.ndarray, lengths: np.ndarray, k: int,
             identity: float, params, chunk: int = 512) -> List[Tuple[int, int]]:
    """Every (read, strand) that carries the junction: strand 0 the read as
    stored, 1 its reverse complement. ``params``: (match, mismatch,
    gap_open, gap_extend), gap costs >= 0."""
    assert params[2] >= 0 and params[3] >= 0, "gap costs below 0"
    reads = np.asarray(reads, dtype=np.int8)
    lengths = np.asarray(lengths)
    n = len(lengths)
    if n == 0 or len(window) == 0:
        return []
    lt = int(lengths.max())
    both = np.full((2 * n, lt), 4, dtype=np.int8)
    for r in range(n):
        row = reads[r, :lengths[r]]
        both[2 * r, :len(row)] = row
        both[2 * r + 1, :len(row)] = _revcomp(row)
    q = np.asarray(window, dtype=np.int8)
    out = []
    for s in range(0, 2 * n, chunk):
        ok = _carried(q, both[s:s + chunk], a, b, k, identity, tuple(int(x) for x in params))
        out += [((s + int(x)) // 2, (s + int(x)) % 2) for x in np.flatnonzero(ok)]
    return out


def germline(window: np.ndarray, a: int, b: int, reads: np.ndarray, lengths: np.ndarray, k: int,
             identity: float, params) -> bool:
    """The verdict: germline where any normal read carries the junction."""
    return bool(carriers(window, a, b, reads, lengths, k, identity, params))
