"""Affine-gap local alignment scores in numpy (Smith-Waterman-Gotoh).

H(i, j) = max(0, H(i-1, j-1) + s(q_i, t_j), E(i, j), F(i, j)),
E(i, j) = max(H(i, j-1) - (open + extend), E(i, j-1) - extend) along t,
F(i, j) = max(H(i-1, j) - (open + extend), F(i-1, j) - extend) along q,
s = match where the codes are equal, -mismatch otherwise, and a base of
code 4 or more (N or pad) scores against nothing. Per pair: the best H,
and its cell (q_end, t_end), the first in the order of the anti-diagonal
i + j and then of i; (0, -1, -1) where no cell scores above 0. Rows are
computed one at a time over all pairs, E by a running maximum (valid for
a gap open cost of 0 or more). ``bits`` saturates every value at a
signed integer of that width: the lower-precision control."""

from __future__ import annotations

from typing import Tuple

import numpy as np

NEG = -(1 << 40)


def sw(q: np.ndarray, t: np.ndarray, match: int, mismatch: int, gap_open: int,
       gap_extend: int, bits: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    q = np.asarray(q).astype(np.int64)
    t = np.asarray(t).astype(np.int64)
    B, Lq = q.shape
    Lt = t.shape[1]
    go, ge = gap_open + gap_extend, gap_extend
    t_bad = (t >= 4) | (t < 0)
    h_prev = np.zeros((B, Lt + 1), dtype=np.int64)
    f_prev = np.full((B, Lt), NEG, dtype=np.int64)
    ramp = ge * np.arange(Lt, dtype=np.int64)[None, :]
    best = np.zeros(B, dtype=np.int64)
    best_d = np.full(B, np.iinfo(np.int64).max)
    best_i = np.full(B, -1, dtype=np.int64)
    best_j = np.full(B, -1, dtype=np.int64)
    lo, hi = (-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if bits else (NEG, -NEG)
    for i in range(Lq):
        qi = q[:, i:i + 1]
        s = np.where(qi == t, match, -mismatch)
        s[t_bad | (qi >= 4) | (qi < 0)] = NEG
        d = h_prev[:, :-1] + s
        f = np.maximum(h_prev[:, 1:] - go, f_prev - ge)
        hn = np.maximum(np.maximum(d, f), 0)
        # E(j) = max over k < j of hn(k) - go - ge (j - 1 - k)
        run = np.maximum.accumulate(hn + ramp, axis=1)
        e = np.full((B, Lt), NEG, dtype=np.int64)
        e[:, 1:] = run[:, :-1] - go - ramp[:, :-1]
        h = np.clip(np.maximum(hn, e), lo, hi)
        f = np.clip(f, lo, hi)
        jm = np.argmax(h, axis=1)
        hm = h[np.arange(B), jm]
        dm = i + jm
        upd = (hm > best) | ((hm == best) & (hm > 0) & (dm < best_d))
        best = np.where(upd, hm, best)
        best_d = np.where(upd, dm, best_d)
        best_i = np.where(upd, i, best_i)
        best_j = np.where(upd, jm, best_j)
        h_prev[:, 1:] = h
        f_prev = f
    none = best <= 0
    return (np.where(none, 0, best).astype(np.int32), np.where(none, -1, best_i).astype(np.int32),
            np.where(none, -1, best_j).astype(np.int32))
