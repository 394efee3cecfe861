"""Does the matched normal carry an event's junction? The alignment half of
the germline recheck (``pipeline.TargetPipeline._germline_recheck``).

The recheck's k-mer test (``Config.germline_kmer_min`` / ``_frac``) calls an
event germline when most of its junction k-mers are in the normal. Where that
test is inconclusive, this module asks the normal for the junction itself.
An event's query is its contig from ``2k`` bases before the junction span
``[a, b)`` (``SVEvent.junction_q``: the inserted bases of an insertion, the
unaligned or shared bases between two segments, the inverted segment of an
inversion; a point for a deletion) to ``2k`` bases after it. A normal read
carries the junction when, on one of its strands, the optimal local alignment
of the query to the read (``traceback_align``, the tie-breaks of ``sw_score``):

1. holds the junction block, the span and the ``k - 1`` bases on each side of
   it (the bases that every k-mer across the junction covers), in one gapless
   run of aligned columns;
2. holds on each side of the span an exact match of at least ``k`` bases;
3. has an identity of at least ``Config.germline_sw_identity`` over its
   columns, where each gap column counts as a mismatch.

A read that carries one flank only fails 1 and 2; a read of the reference
across a small deletion or insertion carries both flanks, but with a gap at
the junction, and fails 1. The identity threshold is the recheck's existing
0.85: a read that carries the junction differs from the contig only by its
own sequencing errors and the consensus's (about 1 % a base each), so 0.85
over the at least ``2k + 2`` columns leaves room for several errors, while
1 and 2, not the identity, are what separate the carriers from reads of the
reference. Nothing here is a knob.

Not every normal read is aligned. Rule 2 means that a carrier holds, on the
strand that aligns, a k-mer of the query left of the span and one right of
it, so the candidates are the reads that hold both: one pass of the region's
normal k-mers against the events' seed k-mers on the pipeline's device. The
candidates of all of a region's events are scored in one batched SW call,
and traced back only where the alignment ends far enough right of the span to
hold rule 2's right anchor (``sw_score``'s end cell is the traceback's).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from breakmer_tpu_torch.align import realign
from breakmer_tpu_torch.align.traceback import traceback_align
from breakmer_tpu_torch.encode import ReadBatch, encode_seq, revcomp_codes
from breakmer_tpu_torch.ops.kmer import SENTINEL, kmer_codes, kmer_codes_np
from breakmer_tpu_torch.ops.sw import SWParams

PAD = 4


@dataclasses.dataclass
class Junction:
    """One event's query: contig codes and its junction span [a, b)."""

    query: np.ndarray
    a: int
    b: int


@dataclasses.dataclass
class Carrier:
    """The first normal read found to carry a junction."""

    read: int
    strand: int  # 0: the read as stored; 1: its reverse complement
    identity: float
    left: int  # aligned query bases left of the span
    right: int  # and right of it


def junction_query(contig_seq: str, junction_q: Sequence[int], k: int) -> Optional[Junction]:
    """The contig from 2k bases before the junction span to 2k after it."""
    if not junction_q or k < 1:
        return None
    lo, hi = min(junction_q), max(junction_q)
    q0 = max(0, lo - 2 * k)
    q1 = min(len(contig_seq), hi + 2 * k)
    return Junction(encode_seq(contig_seq[q0:q1]), lo - q0, hi - q0)


def carried(aln, q: np.ndarray, t: np.ndarray, a: int, b: int, k: int,
            identity: float) -> Optional[Tuple[float, int, int]]:
    """Rules 1-3 on one alignment of ``q`` to ``t``: (identity, aligned
    query bases left of the span, right of it) where it carries the
    junction, else None."""
    if aln.score <= 0:
        return None
    lo, hi = a - (k - 1), b + (k - 1)  # the junction block
    if aln.q_start > lo or aln.q_end < hi:
        return None
    block = left_run = right_run = gaps = 0
    qpos, tpos = aln.q_start, aln.t_start
    for op, ln in aln.ops:
        if op == "M":
            if qpos <= lo and qpos + ln >= hi:
                block = 1
            eq = (q[qpos:qpos + ln] == t[tpos:tpos + ln]) & (q[qpos:qpos + ln] < PAD)
            ends = np.flatnonzero(np.diff(np.r_[0, eq.astype(np.int8), 0]))
            for s, e in zip(qpos + ends[::2], qpos + ends[1::2]):
                left_run = max(left_run, min(e, a) - s)
                right_run = max(right_run, e - max(s, b))
            qpos += ln
            tpos += ln
        else:
            gaps += ln
            if op == "I":
                qpos += ln
            else:
                tpos += ln
    cols = aln.matches + aln.mismatches + gaps
    ident = aln.matches / cols
    if not block or left_run < k or right_run < k or ident < identity:
        return None
    return ident, a - aln.q_start, aln.q_end - b


def _seeds(j: Junction, k: int) -> List[Tuple[np.ndarray, int, int]]:
    """(k-mer codes, side, strand): the query's k-mers left of the span
    (side 0) and right of it (side 1), as a read holds them on its stored
    strand (0) or as its reverse complement holds them (1)."""
    n = len(j.query)
    rq = revcomp_codes(j.query)
    out = []
    for side, strand, part in ((0, 0, j.query[:j.a]), (1, 0, j.query[j.b:]),
                               (0, 1, rq[n - j.a:]), (1, 1, rq[:n - j.b])):
        if len(part) < k:
            continue
        v, _ = kmer_codes_np(part.reshape(1, -1), np.asarray([len(part)]), k)
        v = v.reshape(-1)
        out.append((np.unique(v[v != SENTINEL]).astype(np.int64), side, strand))
    return out


def candidates(junctions: Sequence[Junction], normal: ReadBatch, k: int, *,
               device) -> Dict[Tuple[int, int], np.ndarray]:
    """{(junction, strand): indices of the normal reads that hold a seed
    k-mer of each side on that strand}, ascending; one pass of the normal's
    k-mers against every junction's seeds on ``device``."""
    codes, owners = [], []
    for u, j in enumerate(junctions):
        for v, side, strand in _seeds(j, k):
            codes.append(v)
            owners.append(np.full(len(v), (u * 2 + strand) * 2 + side, dtype=np.int64))
    if not codes or not len(normal) or normal.codes.shape[1] < k:
        return {}
    codes, owners = np.concatenate(codes), np.concatenate(owners)
    order = np.argsort(codes, kind="stable")
    codes, owners = codes[order], owners[order]
    table, first = np.unique(codes, return_index=True)
    n_owners = np.diff(np.r_[first, len(codes)])
    km, _ = kmer_codes(torch.from_numpy(np.ascontiguousarray(normal.codes, dtype=np.int8)).to(device),
                       torch.from_numpy(np.asarray(normal.lengths, dtype=np.int32)).to(device), k)
    tab = torch.from_numpy(table).to(km.device)
    at = torch.searchsorted(tab, km).clamp_max(len(table) - 1)
    read, col = torch.nonzero(tab[at] == km, as_tuple=True)
    hit = at[read, col].cpu().numpy()
    read = read.cpu().numpy()
    # each hit once for every owner of its k-mer
    reps = n_owners[hit]
    read = np.repeat(read, reps)
    starts = np.repeat(first[hit], reps)
    within = np.arange(len(read)) - np.repeat(np.cumsum(reps) - reps, reps)
    owner = owners[starts + within]
    key, side = (owner >> 1) * len(normal) + read, owner & 1
    uniq, inv = np.unique(key, return_inverse=True)
    sides = np.zeros(len(uniq), dtype=np.int64)
    np.bitwise_or.at(sides, inv, 1 << side)
    both = uniq[sides == 3]
    out: Dict[Tuple[int, int], np.ndarray] = {}
    for unit_strand in np.unique(both // len(normal)):
        reads = both[both // len(normal) == unit_strand] % len(normal)
        out[(int(unit_strand) // 2, int(unit_strand) % 2)] = reads
    return out


def find_carriers(junctions: Sequence[Junction], normal: ReadBatch, params: SWParams, k: int,
                  identity: float, *, device, counts: Optional[dict] = None) -> List[Optional[Carrier]]:
    """For each junction, the first normal read (in read order, the stored
    strand first) that carries it, or None. One SW call scores every
    candidate pair; ``counts`` gains the candidate pairs and the alignments
    traced back."""
    found: List[Optional[Carrier]] = [None] * len(junctions)
    cand = candidates(junctions, normal, k, device=device)
    pairs = sorted((u, int(r), s) for (u, s), reads in cand.items() for r in reads)
    if counts is not None:
        counts["candidates"] = counts.get("candidates", 0) + len(pairs)
    if not pairs:
        return found
    reads = {}
    for _, r, s in pairs:
        if (r, s) not in reads:
            t = normal.codes[r, :normal.lengths[r]]
            reads[(r, s)] = revcomp_codes(t) if s else np.asarray(t, dtype=np.int8)
    lq = max(len(junctions[u].query) for u, _, _ in pairs)
    lt = max(len(reads[(r, s)]) for _, r, s in pairs)
    q = np.full((len(pairs), lq), PAD, dtype=np.int8)
    t = np.full((len(pairs), lt), PAD, dtype=np.int8)
    for i, (u, r, s) in enumerate(pairs):
        q[i, :len(junctions[u].query)] = junctions[u].query
        t[i, :len(reads[(r, s)])] = reads[(r, s)]
    # through realign's name, where every SW call of a sample is made
    score, q_end, _ = realign.sw_score_batch(q, t, params, device=device)
    traced = 0
    for i, (u, r, s) in enumerate(pairs):
        j = junctions[u]
        # the right anchor ends at or after b + k; q_end is the last base
        if found[u] is not None or score[i] <= 0 or q_end[i] + 1 < j.b + k:
            continue
        target = reads[(r, s)]
        traced += 1
        hit = carried(traceback_align(j.query, target, params), j.query, target, j.a, j.b, k, identity)
        if hit is not None:
            found[u] = Carrier(r, s, *hit)
    if counts is not None:
        counts["alignments"] = counts.get("alignments", 0) + traced
    return found
