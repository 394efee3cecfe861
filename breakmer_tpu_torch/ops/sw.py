"""Batched affine-gap local alignment (Smith-Waterman): the plain PyTorch
version and the dispatcher in front of the Hopper kernel.

Port of ``breakmer_tpu/ops/sw.py``. The semantics are those of the JAX
scan there, cell for cell: the DP runs as an anti-diagonal wavefront,
the state is the last two diagonals of H and the last diagonal of E and
F as [B, Lq] tensors indexed by query position i (cell (i, j = d - i)).
A gap of length g costs ``gap_open + gap_extend * g``; a base code >= 4
(N or pad) scores NEG against anything. Per pair the result is the best
H and its end cell, tie-broken by (score desc, i + j asc, i asc); a best
score <= 0 gives (0, -1, -1).

``sw_score`` is the plain version: a Python loop over diagonals of
elementwise torch ops, on any device. The CPU tests hold it against the
JAX package, and ``chip_smoke.py`` holds the CUDA kernel
(``ops/sw_cuda.py``) against it on the card. ``sw_score_auto`` sends a
CUDA tensor to the kernel and a CPU tensor to the plain version.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from breakmer_tpu_torch.utils.meter import METER

NEG = -(1 << 28)


class SWParams(NamedTuple):
    match: int = 2
    mismatch: int = 3      # subtracted
    gap_open: int = 5      # first gapped base costs gap_open + gap_extend
    gap_extend: int = 1


def sw_score(
    q: torch.Tensor, t: torch.Tensor, params: SWParams = SWParams()
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best local-alignment score per (query, target) pair.

    The domain is the JAX scan's: any int8 code (one below 0 is a base
    that matches only its own code; 4 and above score NEG) and any int32
    scoring parameters of either sign, in int32 arithmetic that is exact
    until a value wraps, as the scan's does (row 0's F, NEG - gap_open -
    gap_extend, wraps first as the gap costs grow). At Lt = 0
    every pair gives (0, -1, -1); Lq = 0 raises ``ValueError``, as the JAX
    scan does.

    Args:
      q: [B, Lq] int8 base codes (>= 4 = pad/N).
      t: [B, Lt] int8 base codes (>= 4 = pad/N).
      params: scoring parameters.

    Returns:
      (score [B] int32, q_end [B] int32, t_end [B] int32) on q's device.
    """
    B, Lq = q.shape
    Lt = t.shape[1]
    if Lq == 0:
        raise ValueError(f"sw_score: a query of no base (q {tuple(q.shape)})")
    dev = q.device
    i32 = torch.int32
    go = params.gap_open + params.gap_extend
    ge = params.gap_extend

    qi = q.to(i32)
    q_bad = qi >= 4
    # reversed, padded target so each step's t[d-i] (i=0..Lq-1) is one
    # contiguous slice: t_ext[(Lq-1) + (Lt-1-d) + i] == t[d-i]
    pad = torch.full((B, Lq - 1), 4, dtype=i32, device=dev)
    t_ext = torch.cat([pad, t.flip(1).to(i32), pad], dim=1)
    t_ext_bad = t_ext >= 4

    h_d1 = torch.zeros((B, Lq), dtype=i32, device=dev)
    h_d2 = torch.zeros((B, Lq), dtype=i32, device=dev)
    e_d1 = torch.full((B, Lq), NEG, dtype=i32, device=dev)
    f_d1 = torch.full((B, Lq), NEG, dtype=i32, device=dev)
    best = torch.zeros((B,), dtype=i32, device=dev)
    best_i = torch.full((B,), -1, dtype=i32, device=dev)
    best_j = torch.full((B,), -1, dtype=i32, device=dev)
    f0 = max(NEG - go, NEG - ge)  # F of row 0: shift fill NEG on both terms

    for d in range(Lq + Lt - 1):
        start = (Lq - 1) + (Lt - 1) - d
        tj = t_ext[:, start : start + Lq]
        sub = (qi == tj).to(i32) * (params.match + params.mismatch) - params.mismatch
        sub.masked_fill_(q_bad | t_ext_bad[:, start : start + Lq], NEG)
        e_new = torch.maximum(h_d1 - go, e_d1 - ge)              # from (i, j-1)
        f_new = torch.empty_like(h_d1)                            # from (i-1, j)
        f_new[:, 0] = f0
        torch.maximum(h_d1[:, :-1] - go, f_d1[:, :-1] - ge, out=f_new[:, 1:])
        h_diag = torch.empty_like(h_d2)                           # from (i-1, j-1)
        h_diag[:, 0] = 0
        h_diag[:, 1:] = h_d2[:, :-1]
        if d < Lq:
            # cell (d, j=0): no j-1 column — diagonal neighbour 0, no E
            h_diag[:, d] = 0
            e_new[:, d] = NEG
        h_new = torch.maximum(
            torch.clamp_min(h_diag + sub, 0), torch.maximum(e_new, f_new)
        )
        # cells with j = d - i outside [0, Lt) reset: i outside [lo, hi]
        lo, hi = max(0, d - Lt + 1), min(Lq - 1, d)
        for a, b in ((0, lo), (hi + 1, Lq)):
            if b > a:
                h_new[:, a:b] = 0
                e_new[:, a:b] = NEG
                f_new[:, a:b] = NEG

        step_arg = torch.argmax(h_new, dim=1, keepdim=True)  # first max index
        step_best = h_new.gather(1, step_arg)[:, 0]
        step_arg = step_arg[:, 0].to(i32)
        upd = step_best > best
        best = torch.where(upd, step_best, best)
        best_i = torch.where(upd, step_arg, best_i)
        best_j = torch.where(upd, d - step_arg, best_j)
        h_d2, h_d1, e_d1, f_d1 = h_d1, h_new, e_new, f_new

    none = best <= 0
    return (
        torch.where(none, 0, best),
        torch.where(none, -1, best_i),
        torch.where(none, -1, best_j),
    )


def sw_score_auto(
    q: torch.Tensor, t: torch.Tensor, params: SWParams = SWParams(),
    no_n: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device-dispatching SW: the hand-written CUDA kernel for CUDA
    tensors (it launches or raises), the plain version for CPU tensors.
    Identical results either way.

    no_n: caller asserts no mid-sequence N in either input (trailing pad
    4s are fine) — lets the kernel take its compare-and-select
    substitution; results are unchanged."""
    if q.device.type == "cuda":
        from breakmer_tpu_torch.ops.sw_cuda import sw_score_cuda

        return sw_score_cuda(q, t, params, no_n=no_n)
    if q.device.type == "cpu":
        return sw_score(q, t, params)
    raise ValueError(f"sw_score_auto: no SW implementation for device {q.device}")


def sw_score_batch(q, t, params: SWParams = SWParams(), no_n: bool = False, *,
                   device):
    """Host entry point: numpy int8 codes in, numpy int32 (score, q_end, t_end)
    out, computed on ``device``. One device-to-host copy for all three
    outputs; the METER bracket spans upload, kernel and fetch."""
    t0 = time.perf_counter()
    qd = torch.from_numpy(np.ascontiguousarray(q, dtype=np.int8)).to(device)
    td = torch.from_numpy(np.ascontiguousarray(t, dtype=np.int8)).to(device)
    out = torch.stack(sw_score_auto(qd, td, params, no_n=no_n)).cpu().numpy()
    res = tuple(out)
    METER.add_sw(q.shape[0] * q.shape[1] * t.shape[1], time.perf_counter() - t0)
    return res
