"""The fused region step: k-mer subtraction and batched SW scoring of G
regions in one call.

Port of ``breakmer_tpu/parallel/step.py`` in its unsharded form
(``make_region_step(mesh=None)``), the step ``__graft_entry__.entry``
returns and ``bench.py`` times:

  in:  reads [G, R, L] int8, lengths [G, R] int32, refs [G, Lref] int8,
       ref_lengths [G] int32, SW pairs q [G, B, Lq] / t [G, B, Lt] int8
  out: per-region sample-only k-mer values / counts, SW scores and ends

The JAX step ``vmap``s over regions; here the k-mer half is a loop over
the G regions (each a handful of torch ops over R·W codes) and the SW
half is one ``sw_score_auto`` call over all G·B pairs, reshaped back to
[G, B]: one kernel launch a step on the card. SW tie-breaks are per pair,
so flattening changes no result. The k-mer values are int64 on the
device, as in ``ops/kmer.py``; ``to_numpy`` gives the JAX step's dtypes
(values ``np.uint32``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from breakmer_tpu_torch.ops.kmer import (
    _SENT, kmer_codes, revcomp_kmers, sort_kmers, subtract_sorted,
    unique_counts_sorted,
)
from breakmer_tpu_torch.ops.sw import SWParams, sw_score_auto


def _per_region_kmers(reads, lengths, ref, ref_length,
                      normal_reads=None, normal_lengths=None,
                      *, k: int, min_count: int):
    """One region: sample-only k-mer values/counts (static shapes: one
    slot per sample k-mer window, SENTINEL / 0 where none is kept).
    ``normal_reads``/``normal_lengths`` add the matched-normal
    subtraction, as in the JAX step."""
    km, _ = kmer_codes(reads, lengths, k)
    values, counts, _ = unique_counts_sorted(sort_kmers(km))
    rkm, _ = kmer_codes(ref[None, :], ref_length[None], k)
    rkm = rkm.reshape(-1)
    table = torch.sort(torch.cat([rkm, revcomp_kmers(rkm, k)])).values
    normal_table = None
    if normal_reads is not None:
        nkm, _ = kmer_codes(normal_reads, normal_lengths, k)
        normal_table = sort_kmers(nkm)
    values, counts = subtract_sorted(values, counts, table, normal_table)
    keep = counts >= min_count
    return values.masked_fill(~keep, _SENT), counts.masked_fill(~keep, 0)


def make_region_step(
    mesh=None,
    k: int = 15,
    min_count: int = 2,
    params: SWParams = SWParams(),
) -> Callable:
    """Build the region step on one device.

    Signature of the returned fn (all tensors on one device):
      step(reads [G,R,L] i8, lengths [G,R] i32, refs [G,Lref] i8,
           ref_lengths [G] i32, q [G,B,Lq] i8, t [G,B,Lt] i8)
        -> (kmer_values [G,N] i64, kmer_counts [G,N] i32,
            scores [G,B] i32, q_end [G,B] i32, t_end [G,B] i32)
    with N = R * (L - k + 1).
    """
    if mesh is not None:
        raise NotImplementedError(
            "make_region_step(mesh=...): the sharded region step is not "
            "ported yet (ROADMAP Queue 1, item 2); pass mesh=None"
        )

    def step(reads, lengths, refs, ref_lengths, q, t):
        per_region = [
            _per_region_kmers(reads[g], lengths[g], refs[g], ref_lengths[g],
                              k=k, min_count=min_count)
            for g in range(reads.shape[0])
        ]
        values = torch.stack([v for v, _ in per_region])
        counts = torch.stack([c for _, c in per_region])
        G, B = q.shape[:2]
        flat = sw_score_auto(q.reshape(G * B, -1), t.reshape(G * B, -1), params)
        scores, q_end, t_end = (x.reshape(G, B) for x in flat)
        return values, counts, scores, q_end, t_end

    return step


def to_numpy(out) -> Tuple[np.ndarray, ...]:
    """The step's outputs as host numpy arrays with the JAX step's dtypes
    (k-mer values uint32, SENTINEL = 0xFFFFFFFF)."""
    values, *rest = (x.cpu().numpy() for x in out)
    return (values.astype(np.uint32), *rest)
