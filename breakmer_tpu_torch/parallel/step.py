"""The fused region step: k-mer subtraction and batched SW scoring of G
regions in one call, on one device or sharded over a mesh.

Port of ``breakmer_tpu/parallel/step.py`` (``make_region_step``), the
step ``__graft_entry__.entry`` returns and ``bench.py`` times:

  in:  reads [G, R, L] int8, lengths [G, R] int32, refs [G, Lref] int8,
       ref_lengths [G] int32, SW pairs q [G, B, Lq] / t [G, B, Lt] int8
  out: per-region sample-only k-mer values / counts, SW scores and ends

The JAX step ``vmap``s ``_per_region_kmers`` over regions; here the
region dim is written out: one call of each k-mer function over all G
regions (row-wise sorts, and on a card one launch of each k-mer kernel,
three of ``kmer_codes``; ``ops/kmer.py``). The
SW half is one ``sw_score_auto`` call over all G·B pairs, reshaped back
to [G, B]: one kernel launch a step on the card. SW tie-breaks are per
pair, so flattening changes no result. The k-mer values are int64 on the
device, as in ``ops/kmer.py``; ``to_numpy`` gives the JAX step's dtypes
(values ``np.uint32``). ``parallel/kmer_batch.py`` shares
``_per_region_kmers``, as the JAX package does.

With a (regions, pairs) mesh (``parallel/mesh.py``) the step is the JAX
``shard_map``: shard (i, j) holds regions block i and pairs block j and
scores its SW block on its own device (one launch a shard a step); the
k-mer half, which JAX replicates over the pairs axis, runs once a
regions block on the row's first device. The outputs are gathered over
pairs, then over regions, onto the mesh's first device (``out_specs=P()``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from breakmer_tpu_torch.ops.kmer import (
    _SENT, kmer_codes, revcomp_kmers, sort_kmers, subtract_sorted,
    unique_counts_sorted,
)
from breakmer_tpu_torch.ops.sw import SWParams, sw_score_auto
from breakmer_tpu_torch.parallel.mesh import gather, on_device, split_evenly


def _per_region_kmers(reads, lengths, refs, ref_lengths,
                      normal_reads=None, normal_lengths=None,
                      *, k: int, min_count: int):
    """G regions at once: sample-only k-mer values/counts [G, N], with
    N = R * (L - k + 1) (static shapes: one slot per sample k-mer window,
    SENTINEL / 0 where none is kept).

    reads [G, R, L], lengths [G, R], refs [G, Lref], ref_lengths [G];
    ``normal_reads`` [G, Rn, Ln] / ``normal_lengths`` [G, Rn] add the
    matched-normal subtraction (one-strand normal table, as in the JAX
    step). A region with no normal reads passes all-PAD rows, whose
    k-mer table is all sentinels and subtracts nothing."""
    G, R, L = reads.shape
    km, _ = kmer_codes(reads.reshape(G * R, L), lengths.reshape(G * R), k)
    values, counts, _ = unique_counts_sorted(sort_kmers(km.reshape(G, -1), 1))
    rkm, _ = kmer_codes(refs, ref_lengths, k)
    table = torch.sort(torch.cat([rkm, revcomp_kmers(rkm, k)], dim=-1), dim=-1).values
    normal_table = None
    if normal_reads is not None:
        Rn, Ln = normal_reads.shape[1:]
        nkm, _ = kmer_codes(normal_reads.reshape(G * Rn, Ln),
                            normal_lengths.reshape(G * Rn), k)
        normal_table = sort_kmers(nkm.reshape(G, -1), 1)
    values, counts = subtract_sorted(values, counts, table, normal_table)
    keep = counts >= min_count
    return values.masked_fill(~keep, _SENT), counts.masked_fill(~keep, 0)


def make_region_step(
    mesh=None,
    k: int = 15,
    min_count: int = 2,
    params: SWParams = SWParams(),
) -> Callable:
    """Build the region step, unsharded or over a (regions, pairs) mesh.

    Signature of the returned fn:
      step(reads [G,R,L] i8, lengths [G,R] i32, refs [G,Lref] i8,
           ref_lengths [G] i32, q [G,B,Lq] i8, t [G,B,Lt] i8)
        -> (kmer_values [G,N] i64, kmer_counts [G,N] i32,
            scores [G,B] i32, q_end [G,B] i32, t_end [G,B] i32)
    with N = R * (L - k + 1). Unsharded, the inputs lie on one device and
    so do the outputs. Sharded, G must split evenly over the regions axis
    and B over the pairs axis; the inputs may lie anywhere (each block is
    copied to its shard's device) and the outputs lie on the mesh's first
    device.
    """

    def kmers(reads, lengths, refs, ref_lengths):
        return _per_region_kmers(reads, lengths, refs, ref_lengths,
                                 k=k, min_count=min_count)

    def sw(q, t):
        G, B = q.shape[:2]
        flat = sw_score_auto(q.reshape(G * B, -1), t.reshape(G * B, -1), params)
        return tuple(x.reshape(G, B) for x in flat)

    def step(reads, lengths, refs, ref_lengths, q, t):
        return (*kmers(reads, lengths, refs, ref_lengths), *sw(q, t))

    if mesh is None:
        return step

    devices = mesh.devices

    def sharded(reads, lengths, refs, ref_lengths, q, t):
        G, B = q.shape[:2]
        rows = split_evenly(G, devices.shape[0], "G (regions)")
        cols = split_evenly(B, devices.shape[1], "B (pairs)")
        kmer_parts, sw_rows = [], []
        for i, gs in enumerate(rows):
            d = devices[i, 0]
            with on_device(d):
                kmer_parts.append(kmers(*(x[gs].to(d) for x in (reads, lengths, refs,
                                                                  ref_lengths))))
            blocks = []
            for j, bs in enumerate(cols):
                d = devices[i, j]
                with on_device(d):
                    blocks.append(sw(q[gs, bs].to(d), t[gs, bs].to(d)))
            # pairs-axis gather completes each region's SW batch
            sw_rows.append([gather([b[n] for b in blocks], mesh.first, 1) for n in range(3)])
        # regions-axis gather: the call-set merge
        return (gather([p[0] for p in kmer_parts], mesh.first),
                gather([p[1] for p in kmer_parts], mesh.first),
                *(gather([r[n] for r in sw_rows], mesh.first) for n in range(3)))

    return sharded


def to_numpy(out) -> Tuple[np.ndarray, ...]:
    """The step's outputs as host numpy arrays with the JAX step's dtypes
    (k-mer values uint32, SENTINEL = 0xFFFFFFFF)."""
    values, *rest = (x.cpu().numpy() for x in out)
    return (values.astype(np.uint32), *rest)
