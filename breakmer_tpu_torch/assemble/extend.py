"""Repeat-aware contig extension over ALL region reads (r5).

Why this exists (beyond reference behavior): assembly consumes only
SV-informative reads, and inside a tandem array most reads covering an
indel are slippage-ABSORBED — they match the reference cleanly and are
correctly never extracted, so the assembled contig ends a few dozen
bases past the junction, still inside the array, where the event is
representation-ambiguous: SW aligns the short contig gaplessly and the
call vanishes (or slips by one repeat unit). The r5 true-haplotype
oracle (TANDEM_FLOOR_r05.json) measured 32/45 tandem misses as exactly
this: the same pipeline called them correctly when handed the wider alt
haplotype. The missing bases are IN the sample — carried by the
clean-mapped reads the extractor (correctly) skipped.

This pass extends each assembled contig outward through those reads by
chained OLC: an exact terminal-anchor lookup (k=31, injective 2-bit
hash — no collisions possible) RECRUITS region reads (both strands)
whose full overlap with the consensus verifies, each read is placed
exactly once at its best-verified offset, and a per-column majority
vote (min support 2, >= 70% agreement) over all placed reads' pending
content appends the consensus continuation — until the vote degrades,
pending content runs out, unique flank is passed, or the growth cap.
Votes are counts, so the result is order-independent; ties pick the
smaller base code (pinned). The once-only placement rule is
load-bearing: per-round re-anchoring let slipped placements walk the
repeat torus (see _grow_right). Extension fires only for contigs that
touch repetitive context (_needs_extension), so non-repetitive panels
pay ~nothing.

The reference pipeline (BreaKmer, sv_assembly.py [recon]) has no
equivalent; it assembles sv-read fastqs only and inherits the absorbed
blind spot. Config knobs: ``contig_extension`` (default on),
``extension_anchor_k``, ``extension_max_grow``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from breakmer_tpu_torch.assemble.greedy import Contig, ContigRead
from breakmer_tpu.encode import ReadBatch, decode_seq, encode_seq, revcomp_codes


def _anchor_hashes(codes: np.ndarray, lengths: np.ndarray, k: int):
    """uint64 2-bit rolling codes of every length-k window: [R, W] plus
    validity (in-length, N-free). k <= 31 fits 62 bits — injective, so a
    hash EQUALITY is an exact sequence match (no verification pass)."""
    R, L = codes.shape
    W = L - k + 1
    if W <= 0 or R == 0:
        return (np.zeros((R, 0), dtype=np.uint64),
                np.zeros((R, 0), dtype=bool))
    acc = np.zeros((R, W), dtype=np.uint64)
    bad = np.zeros((R, W), dtype=bool)
    for j in range(k):
        win = codes[:, j:j + W]
        bad |= win >= 4
        acc = (acc << np.uint64(2)) | np.where(
            win >= 4, 0, win).astype(np.uint64)
    pos = np.arange(W, dtype=np.int64)[None, :]
    valid = (pos <= (lengths[:, None] - k)) & ~bad
    return acc, valid


def _hash_one(codes: np.ndarray) -> int:
    h = np.uint64(0)
    for c in codes:
        h = (h << np.uint64(2)) | np.uint64(int(c))
    return int(h)


class ReadAnchorIndex:
    """Exact k-anchor lookup over a region's reads, both strands.

    rows: oriented code matrices (row r strand '-' is the revcomp of
    read r, left-aligned to its true length) so an anchor hit at (row,
    pos, strand) continues with ``oriented[row, pos+k:length]``."""

    def __init__(self, batch: ReadBatch, k: int):
        self.k = k
        codes = np.asarray(batch.codes, dtype=np.int8)
        lengths = np.asarray(batch.lengths, dtype=np.int64)
        R, L = codes.shape
        # vectorized per-row revcomp onto left-aligned true lengths (the
        # per-read loop was ~0.2 s at deep-coverage region sizes)
        if R:
            comp = np.where(codes < 4, 3 - codes, codes)
            src = lengths[:, None] - 1 - np.arange(L)[None, :]
            rc = np.where(
                src >= 0,
                np.take_along_axis(comp, np.clip(src, 0, L - 1), axis=1),
                4,
            ).astype(np.int8)
        else:
            rc = np.full_like(codes, 4)
        self.oriented = np.stack([codes, rc]) if R else np.zeros(
            (2, 0, 0), dtype=np.int8)  # [strand, R, L]
        self.lengths = lengths
        # [strand, R, W] hash matrices kept UNsorted: a flattened
        # hash-sorted table cost ~150 MB + ~1 s lexsort at deep-coverage
        # region sizes, while extension performs only ~10^2 lookups per
        # region — a vectorized equality scan (~ms over the matrices) is
        # cheaper in both time and memory, and its row-major nonzero
        # order (strand, row, pos ascending) is the pinned deterministic
        # hit order.
        hf, vf = _anchor_hashes(codes, lengths, k)
        hr, vr = _anchor_hashes(rc, lengths, k)
        self._h = np.stack([hf, hr]) if R and hf.size else np.zeros(
            (2, R, 0), dtype=np.uint64)
        self._v = np.stack([vf, vr]) if R and hf.size else np.zeros(
            (2, R, 0), dtype=bool)

    def lookup(self, h: int):
        """(strand, row, pos) arrays of every exact anchor occurrence."""
        if not self._h.size:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z
        s, r, p = np.nonzero((self._h == np.uint64(h)) & self._v)
        return s.astype(np.int64), r.astype(np.int64), p.astype(np.int64)


class RegionAnchorCounts:
    """Occurrence counts of every k-anchor in the region reference (both
    strands): the growth stop condition. A terminal anchor occurring
    exactly once in the region means the contig end has exited the
    repeat context into unique flank — growing further adds no
    representation power and, past the alt-read pool, risks crossing
    onto the other haplotype's phase (the measured chimera mode)."""

    def __init__(self, region_codes: np.ndarray, k: int):
        self._codes = np.asarray(region_codes, dtype=np.int8)
        self._k = k
        self._sorted = None
        self._probe = None

    def _table(self, k: int) -> np.ndarray:
        codes = self._codes.reshape(1, -1)
        n = np.array([codes.shape[1]], dtype=np.int64)
        rc = revcomp_codes(self._codes).reshape(1, -1)
        hf, vf = _anchor_hashes(codes, n, k)
        hr, vr = _anchor_hashes(rc, n, k)
        return np.sort(np.concatenate([hf[vf], hr[vr]]))

    @property
    def sorted(self) -> np.ndarray:
        # lazy: only regions whose gate probe FIRED ever pay the
        # k=31 table build (the always-paid work is probe_sorted; both
        # tables per region measured ~40% warm 100-gene panel overhead
        # when built eagerly)
        if self._sorted is None:
            self._sorted = self._table(self._k)
        return self._sorted

    @property
    def probe_sorted(self) -> np.ndarray:
        if self._probe is None:
            self._probe = self._table(_PROBE_K)
        return self._probe

    def count(self, h: int) -> int:
        u = np.uint64(h)
        table = self.sorted
        return int(np.searchsorted(table, u, "right")
                   - np.searchsorted(table, u, "left"))


def _grow_right(codes: np.ndarray, index: ReadAnchorIndex,
                min_votes: int, min_frac: float, max_grow: int,
                region: Optional[RegionAnchorCounts] = None,
                unique_buffer: int = 60,
                max_rounds: int = 64) -> np.ndarray:
    """Chained-OLC growth: each read is PLACED once, at its best
    fully-verified offset against the consensus, and contributes its
    content exactly once. Two earlier designs failed measurably:

    * per-round re-anchoring let the same reads re-enter at slipped
      positions forever inside a pure tandem array — the consensus
      walked the repeat torus to the cap, fabricating a chimeric unit
      count (a 37 bp del came back as a spurious tandem_dup);
    * a terminal-anchor cycle detector stopped the torus but
      over-triggered: ANY pure 31-mer recurrence (two adjacent clean
      units) truncated legitimate growth mid-array, stranding the
      contig before unique flank.

    With placements fixed at recruitment, re-entry is impossible (no
    torus), growth is bounded by real read extents, and a recurring
    anchor inside the array is fine — the placed reads' pending content
    keeps advancing. Recruitment verifies the read's FULL overlap with
    the consensus (<= 1 mismatch per 50 bp, sequencing-error
    allowance); the verified-overlap requirement is the haplotype-phase
    filter, and per-column majority (min_votes / min_frac) arbitrates
    what the placed population disagrees on."""
    k = index.k
    n0 = len(codes)
    # bases still to grow after unique flank was reached (-1 = not yet)
    past_unique = -1
    placements = {}  # row -> (strand, offset of read base 0 in codes)
    for _ in range(max_rounds):
        if len(codes) < k or len(codes) - n0 >= max_grow:
            break
        if past_unique == 0:
            break
        tail = codes[-k:]
        if (tail >= 4).any():
            break
        h_tail = _hash_one(tail)
        if region is not None and past_unique < 0:
            if region.count(h_tail) == 1:
                past_unique = unique_buffer
        # ---- recruit new reads whose anchor matches the terminal tail
        strands, rows, poss = index.lookup(h_tail)
        anchor_off = len(codes) - k
        best_new = {}
        for s, r, p in zip(strands, rows, poss):
            ri = int(r)
            if ri in placements:
                continue
            off = anchor_off - int(p)
            n = int(index.lengths[r])
            lo = max(0, off)
            hi = min(len(codes), off + n)
            ov = hi - lo
            if ov <= 0 or off + n <= len(codes):
                continue  # nothing pending beyond the frontier
            a = index.oriented[s, r, lo - off:hi - off]
            b = codes[lo:hi]
            mm = int(np.sum(a != b))
            if mm > max(1, ov // 50):
                continue
            # best placement per read: longest verified overlap, then
            # the LEAST-slipped offset (largest p <=> smallest pending
            # tail), then strand — deterministic
            cand = (ov, -off, int(s))
            cur = best_new.get(ri)
            if cur is None or cand > cur:
                best_new[ri] = cand
        for ri, (ov, noff, s) in best_new.items():
            placements[ri] = (s, -noff)
        # ---- vote the next columns from ALL placed pending content
        exts = []
        for ri, (s, off) in placements.items():
            n = int(index.lengths[ri])
            if off + n > len(codes):
                exts.append(index.oriented[s, ri, len(codes) - off:n])
        if not exts:
            break
        width = min(max(len(e) for e in exts),
                    max_grow - (len(codes) - n0))
        mat = np.full((len(exts), width), 4, dtype=np.int8)
        for i, e in enumerate(exts):
            mat[i, :min(len(e), width)] = e[:width]
        # per-column votes over A/C/G/T (pad 4 = no vote)
        votes = np.stack([(mat == b).sum(0) for b in range(4)])  # [4, W]
        top = votes.argmax(0)            # ties -> smaller code (argmax)
        support = votes.max(0)
        total = votes.sum(0)
        ok = (support >= min_votes) & (support >= min_frac * np.maximum(
            total, 1))
        n_acc = int(np.argmin(ok)) if not ok.all() else len(ok)
        if past_unique > 0:
            n_acc = min(n_acc, past_unique)
        if n_acc == 0:
            break
        codes = np.concatenate([codes, top[:n_acc].astype(np.int8)])
        if past_unique > 0:
            past_unique -= n_acc
    return codes


def extend_contig_codes(codes: np.ndarray, index: ReadAnchorIndex,
                        min_votes: int = 2, min_frac: float = 0.7,
                        max_grow: int = 400,
                        region: Optional[RegionAnchorCounts] = None,
                        ) -> Tuple[np.ndarray, int, int]:
    """(extended_codes, grow_left, grow_right)."""
    n0 = len(codes)
    codes = _grow_right(codes, index, min_votes, min_frac, max_grow,
                        region=region)
    gr = len(codes) - n0
    # left growth = right growth of the reverse complement (anchor
    # uniqueness is strand-symmetric: RegionAnchorCounts indexes both
    # strands, so the same counter serves the flipped orientation)
    rc = revcomp_codes(codes)
    n1 = len(rc)
    rc = _grow_right(rc, index, min_votes, min_frac, max_grow,
                     region=region)
    gl = len(rc) - n1
    return revcomp_codes(rc), gl, gr


_PROBE_K = 15  # gate probe word; see _needs_extension


def _needs_extension(codes: np.ndarray, region: RegionAnchorCounts,
                     k: int) -> bool:
    """A contig only risks the absorbed representation when it touches
    repetitive context: fire when ANY probe word is region-MULTI-mapped
    (count > 1). Three narrower designs were each measurably wrong:

    * a single terminal 31-anchor (impurity 31-mers inside arrays are
      exact-unique; seed-5 regression);
    * a 40-position end window (repeat context starting 54/66 bp inside
      the contig on two sweep seeds);
    * count != 1 as the trigger — a novel INSERTION's words are absent
      from the reference (count 0), and firing on absence made every
      insertion contig on unique-genome panels pay a pointless
      extension (2.4x warm 100-gene panel cost);
    * the full extension anchor length (31) as the probe word — a
      2%-impure array can have EVERY 31-mer exact-unique while SW still
      absorbs (mismatch-tolerant); at 15 bp the array's purity between
      impurities shows as count > 1 while a random region stays
      collision-free (4^15 >> region size) and insert content stays
      count 0.

    The probe runs over every contig position (vectorized hash +
    searchsorted, sub-ms); the savings target is the all-reads fetch +
    anchor index on non-repetitive regions, not this probe."""
    n = len(codes)
    if n < _PROBE_K:
        return False
    h, v = _anchor_hashes(codes.reshape(1, -1),
                          np.array([n], dtype=np.int64), _PROBE_K)
    hs = h[v]
    if not len(hs):
        return False
    lo = np.searchsorted(region.probe_sorted, hs, "left")
    hi = np.searchsorted(region.probe_sorted, hs, "right")
    return bool(((hi - lo) > 1).any())


def extend_contigs(contigs: List[Contig], all_reads=None,
                   anchor_k: int = 31, min_votes: int = 2,
                   min_frac: float = 0.7, max_grow: int = 400,
                   region_codes: Optional[np.ndarray] = None,
                   ) -> List[Contig]:
    """Extend contigs through the full region read set; read offsets
    are re-based by the left growth so split-read support
    (count_split_reads) keeps counting only the ORIGINAL assembly
    placements — extension never manufactures support.

    ``all_reads``: a ReadBatch, or a zero-arg callable returning one —
    with ``region_codes`` given, the callable is invoked only when some
    contig actually ends in repetitive context (_needs_extension)."""
    if all_reads is None or not contigs:
        return contigs
    region = (RegionAnchorCounts(region_codes, anchor_k)
              if region_codes is not None else None)
    if region is not None:
        needy = [_needs_extension(encode_seq(c.seq), region, anchor_k)
                 for c in contigs]
        if not any(needy):
            return contigs
    else:
        needy = [True] * len(contigs)
    if callable(all_reads):
        all_reads = all_reads()
    if all_reads is None or not len(all_reads):
        return contigs
    index = ReadAnchorIndex(all_reads, anchor_k)
    out: List[Contig] = []
    for c, need in zip(contigs, needy):
        if not need:
            out.append(c)
            continue
        codes = encode_seq(c.seq)
        ext, gl, gr = extend_contig_codes(
            codes, index, min_votes=min_votes, min_frac=min_frac,
            max_grow=max_grow, region=region)
        if gl == 0 and gr == 0:
            out.append(c)
            continue
        reads = [dataclasses.replace(r, offset=r.offset + gl)
                 for r in c.reads]
        out.append(Contig(id=c.id, seq=decode_seq(ext), reads=reads,
                          kmers=c.kmers))
    return out
