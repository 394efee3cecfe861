"""Overlap-layout-consensus helpers.

Reference: olc.py (~150 LoC) — suffix-prefix ``overlap(a, b, min_len)``,
maximal-overlap pair selection, and a greedy shortest-common-superstring
style merge, used for contig consolidation (SURVEY.md §2 #10).
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def overlap(a: str, b: str, min_len: int) -> int:
    """Length of the longest suffix of ``a`` equal to a prefix of ``b``
    with length >= min_len; 0 if none. Exact match (parity rule: the
    reference's overlap is exact string comparison)."""
    start = 0
    while True:
        start = a.find(b[:min_len], start)
        if start == -1:
            return 0
        if b.startswith(a[start:]):
            return len(a) - start
        start += 1


def pick_maximal_overlap(seqs: List[str], min_len: int) -> Tuple[Optional[int], Optional[int], int]:
    """(i, j, olen) of the pair with the largest suffix(i)->prefix(j)
    overlap >= min_len; ties broken by (olen desc, i asc, j asc)."""
    best = (None, None, 0)
    for i, a in enumerate(seqs):
        for j, b in enumerate(seqs):
            if i == j:
                continue
            olen = overlap(a, b, min_len)
            if olen > best[2]:
                best = (i, j, olen)
    return best


def merge_contig_objects(contigs, min_len: int = 20):
    """Read-aware greedy OLC merge of assemble.greedy.Contig objects —
    the production wiring of the reference's contig-consolidation pass
    (reference: olc.py used during contig consensus/merging, SURVEY.md
    §2 #10; VERDICT r1 missing #3). Same rules as :func:`merge_contigs`
    on the sequences, but supporting reads follow their bases:

      * exact containments are removed first, their reads transferring to
        the container at the found offset (first occurrence);
      * then the maximal-overlap pair is fused repeatedly; the absorbed
        contig's reads shift by ``len(a) - olen``;
      * the fused contig keeps the absorbing contig's id; kmer lists are
        unioned in order (contig.kmers has no downstream consumer).

    Duplicate read placements (same read in both sides of a merge) keep
    the first placement.
    """
    from breakmer_tpu_torch.assemble.greedy import Contig, ContigRead

    contigs = list(contigs)
    # drop contigs contained in another (reads transfer to the container)
    kept = []
    for i, c in enumerate(contigs):
        container = None
        for j, t in enumerate(contigs):
            if j != i and c.seq in t.seq and (len(c.seq) < len(t.seq) or j < i):
                container = t
                break
        if container is None:
            kept.append(c)
        else:
            off = container.seq.find(c.seq)
            container.reads.extend(
                ContigRead(r.name, r.index, r.offset + off, r.length)
                for r in c.reads
            )
            container.kmers.extend(k for k in c.kmers if k not in set(container.kmers))
    contigs = kept
    while len(contigs) > 1:
        i, j, olen = pick_maximal_overlap([c.seq for c in contigs], min_len)
        if i is None or olen < min_len:
            break
        a, b = contigs[i], contigs[j]
        shift = len(a.seq) - olen
        merged = Contig(
            id=a.id,
            seq=a.seq + b.seq[olen:],
            reads=list(a.reads) + [
                ContigRead(r.name, r.index, r.offset + shift, r.length)
                for r in b.reads
            ],
            kmers=list(a.kmers) + [k for k in b.kmers if k not in set(a.kmers)],
        )
        rest = [c for idx, c in enumerate(contigs) if idx not in (i, j)]
        contigs = [merged] + rest
    # de-duplicate read placements (a read can sit in both merge sides)
    for c in contigs:
        seen: set = set()
        uniq = []
        for r in c.reads:
            if r.index not in seen:
                seen.add(r.index)
                uniq.append(r)
        c.reads = uniq
    return contigs


def merge_contigs(seqs: List[str], min_len: int = 20) -> List[str]:
    """Greedy merge: repeatedly fuse the maximal-overlap pair until no pair
    overlaps by >= min_len. Also removes exact containments first."""
    seqs = list(seqs)
    # drop sequences contained in another (keep the first occurrence)
    kept: List[str] = []
    for i, s in enumerate(seqs):
        contained = any(
            s in t and (len(s) < len(t) or j < i)
            for j, t in enumerate(seqs)
            if j != i
        )
        if not contained:
            kept.append(s)
    seqs = kept
    while len(seqs) > 1:
        i, j, olen = pick_maximal_overlap(seqs, min_len)
        if i is None or olen < min_len:
            break
        merged = seqs[i] + seqs[j][olen:]
        rest = [s for idx, s in enumerate(seqs) if idx not in (i, j)]
        seqs = [merged] + rest
    return seqs
