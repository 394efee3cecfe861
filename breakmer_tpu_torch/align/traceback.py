"""Host-side affine-gap local alignment with full traceback.

Division of labor (SURVEY.md §7 hard part 4): the device wavefront kernel
(ops/sw.py, ops/sw_pallas.py) scores thousands of (contig, window) pairs
and picks winners; only the few winning pairs per contig come here for the
full DP with traceback that the breakpoint classifier needs (block/gap
structure — the PSL-equivalent; reference: sv_caller.py class blat_res).

Scoring semantics are IDENTICAL to ops.sw.sw_score (same gap model, same
wavefront tie-breaking) — tested against it and against the triple-loop
oracle. The fill is numpy anti-diagonal vectorized: ~Lq+Lt steps of
vector ops, fine for winner-only use.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from breakmer_tpu_torch.ops.sw import SWParams

NEG = -(1 << 28)


@dataclasses.dataclass
class Alignment:
    """A local alignment of query[q_start:q_end] to target[t_start:t_end]
    (half-open), with CIGAR-style ops and block decomposition."""

    score: int
    q_start: int
    q_end: int
    t_start: int
    t_end: int
    ops: List[Tuple[str, int]]          # [('M'|'I'|'D', length)]; I consumes query
    matches: int
    mismatches: int

    @property
    def blocks(self) -> List[Tuple[int, int, int]]:
        """Gapless blocks [(q_start, t_start, length)] — PSL blockSizes/
        qStarts/tStarts equivalent (reference: sv_caller.py blat_res)."""
        out = []
        q, t = self.q_start, self.t_start
        for op, ln in self.ops:
            if op == "M":
                out.append((q, t, ln))
                q += ln
                t += ln
            elif op == "I":
                q += ln
            elif op == "D":
                t += ln
        return out

    @property
    def q_gaps(self) -> List[Tuple[int, int, int]]:
        """Insertions: [(q_pos, t_pos, length)] — query bases absent from
        the target (PSL qNumInsert side)."""
        out = []
        q, t = self.q_start, self.t_start
        for op, ln in self.ops:
            if op == "I":
                out.append((q, t, ln))
                q += ln
            elif op == "D":
                t += ln
            else:
                q += ln
                t += ln
        return out

    @property
    def t_gaps(self) -> List[Tuple[int, int, int]]:
        """Deletions: [(q_pos, t_pos, length)] — target bases absent from
        the query (PSL tNumInsert side)."""
        out = []
        q, t = self.q_start, self.t_start
        for op, ln in self.ops:
            if op == "D":
                out.append((q, t, ln))
                t += ln
            elif op == "I":
                q += ln
            else:
                q += ln
                t += ln
        return out

    @property
    def identity(self) -> float:
        aligned = self.matches + self.mismatches
        return self.matches / aligned if aligned else 0.0

    def cigar_string(self) -> str:
        return "".join(f"{ln}{op}" for op, ln in self.ops)


def _match_anchors(
    aln: Alignment, q: np.ndarray, t: np.ndarray, anchor_len: int
) -> List[Tuple[int, int]]:
    """(q_start, q_end) of exact-match runs >= anchor_len along the path,
    ascending. A random-DNA 'LCS threading' has expected longest run
    ~log4(span) (< 8 for any realistic span); a real locus at the 0.90
    identity floor has SNPs every ~10 bp, so genuine segments keep
    anchors throughout."""
    out: List[Tuple[int, int]] = []
    qpos, tpos = aln.q_start, aln.t_start
    for op, ln in aln.ops:
        if op == "M":
            eq = np.asarray(q[qpos : qpos + ln]) == np.asarray(t[tpos : tpos + ln])
            # run-length scan over the equality mask
            bounds = np.flatnonzero(np.diff(np.r_[0, eq.astype(np.int8), 0]))
            for a, b in zip(bounds[::2], bounds[1::2]):
                if b - a >= anchor_len:
                    out.append((qpos + int(a), qpos + int(b)))
            qpos += ln
            tpos += ln
        elif op == "I":
            qpos += ln
        else:
            tpos += ln
    return out


def _piece_between(
    aln: Alignment, q: np.ndarray, t: np.ndarray, params: SWParams,
    qs: int, qe: int,
) -> Optional[Alignment]:
    """Slice the path to query range [qs, qe) (boundaries always fall on
    M positions), trim non-M edges, recount matches/score exactly."""
    ops: List[Tuple[str, int]] = []
    qpos, tpos = aln.q_start, aln.t_start
    q0 = t0 = None
    for op, ln in aln.ops:
        if op == "M":
            lo = max(qpos, qs)
            hi = min(qpos + ln, qe)
            if hi > lo:
                if q0 is None:
                    q0, t0 = lo, tpos + (lo - qpos)
                ops.append(("M", hi - lo))
            qpos += ln
            tpos += ln
        elif op == "I":
            if q0 is not None and qpos >= qs and qpos + ln <= qe:
                ops.append(("I", ln))
            qpos += ln
        else:
            if q0 is not None and qs < qpos < qe:
                ops.append(("D", ln))
            tpos += ln
    # trim non-M edges (piece must start and end on aligned bases)
    while ops and ops[0][0] != "M":
        op, ln = ops.pop(0)
        if op == "I":
            q0 += ln
        else:
            t0 += ln
    while ops and ops[-1][0] != "M":
        ops.pop()
    if not ops:
        return None
    # merge adjacent same-ops produced by slicing
    merged: List[Tuple[str, int]] = []
    for op, ln in ops:
        if merged and merged[-1][0] == op:
            merged[-1] = (op, merged[-1][1] + ln)
        else:
            merged.append((op, ln))
    matches = mismatches = 0
    score = 0
    qq, tt = q0, t0
    for op, ln in merged:
        if op == "M":
            eq = np.asarray(q[qq : qq + ln]) == np.asarray(t[tt : tt + ln])
            matches += int(np.sum(eq))
            mismatches += ln - int(np.sum(eq))
            qq += ln
            tt += ln
        else:
            score -= params.gap_open + params.gap_extend * ln
            if op == "I":
                qq += ln
            else:
                tt += ln
    score += params.match * matches - params.mismatch * mismatches
    return Alignment(max(score, 0), q0, qq, t0, tt, merged, matches, mismatches)


def _max_score_trim(
    aln: Alignment, q: np.ndarray, t: np.ndarray, params: SWParams
) -> Optional[Alignment]:
    """Trim an alignment to its maximum-scoring sub-path (Kadane over the
    per-column score deltas; gaps are atomic units).

    A genuine Smith-Waterman local alignment can never begin or end with
    a net-negative stretch — the DP would have cut it. Pieces produced by
    splitting a larger alignment lose that invariant: a split boundary is
    not an alignment endpoint, so a piece can keep a gap-riddled random
    threading glued to its good block (measured: a 96-match flank
    dragging 58 junk query bases at net -20, which then STEAL those bases
    from the true inverted segment of the next masking round). Restoring
    the invariant here is exact and deterministic (ties: earliest start,
    then earliest end). Returns None when nothing positive remains."""
    if not aln.ops:
        return None
    # expand the path into atomic units: M per base, I/D per op
    deltas: List[int] = []
    units: List[Tuple[str, int]] = []  # (op, length consumed by this unit)
    qpos, tpos = aln.q_start, aln.t_start
    for op, ln in aln.ops:
        if op == "M":
            eq = np.asarray(q[qpos : qpos + ln]) == np.asarray(t[tpos : tpos + ln])
            deltas.extend(
                int(params.match) if e else -int(params.mismatch) for e in eq
            )
            units.extend(("M", 1) for _ in range(ln))
            qpos += ln
            tpos += ln
        else:
            deltas.append(-(params.gap_open + params.gap_extend * ln))
            units.append((op, ln))
    # Kadane, deterministic: strict > keeps the earliest maximal window
    best, best_a, best_b = 0, -1, -1
    cur, cur_a = 0, 0
    for i, d in enumerate(deltas):
        if cur <= 0:
            cur, cur_a = d, i
        else:
            cur += d
        if cur > best:
            best, best_a, best_b = cur, cur_a, i
    if best <= 0:
        return None
    if best_a == 0 and best_b == len(deltas) - 1:
        return aln  # already maximal — the common case for real segments
    # rebuild ops and coordinates over units [best_a, best_b]
    q0, t0 = aln.q_start, aln.t_start
    for (op, ln) in units[:best_a]:
        if op == "M":
            q0 += ln
            t0 += ln
        elif op == "I":
            q0 += ln
        else:
            t0 += ln
    ops: List[Tuple[str, int]] = []
    qq, tt = q0, t0
    matches = mismatches = 0
    for (op, ln) in units[best_a : best_b + 1]:
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + ln)
        else:
            ops.append((op, ln))
        if op == "M":  # M units are single bases
            if q[qq] == t[tt]:
                matches += 1
            else:
                mismatches += 1
            qq += ln
            tt += ln
        elif op == "I":
            qq += ln
        else:
            tt += ln
    return Alignment(best, q0, qq, t0, tt, ops, matches, mismatches)


def split_alignment(
    aln: Alignment,
    q: np.ndarray,
    t: np.ndarray,
    params: SWParams,
    max_q_gap: int = 50,
    anchor_len: int = 8,
) -> List[Alignment]:
    """Split an alignment at anchor-free query stretches > ``max_q_gap``.

    Parity rule (SURVEY.md §7 hard part 1): BLAT does not emit PSL rows
    whose middle has no seed-tile support — a contig whose middle does
    not match the window (a large novel insert, or an INVERTED segment)
    comes back as separate rows. The affine DP, by contrast, will bridge
    such a middle whenever the flanks pay for it — either as one large
    query gap, or (worse) as a gap-riddled random threading that still
    nets a positive score at gap_extend=1 and shows high gap-EXCLUDING
    identity. Both shapes share one signature: no exact-match run of
    ``anchor_len`` (random DNA's longest run is ~log4(span)) across more
    than ``max_q_gap`` query bases. So: find match anchors, group them,
    and cut between groups separated by more query junk than max_q_gap
    (a pure query gap > max_q_gap is the special case the r1 rule
    handled). Target-gap-only separations contribute zero query junk and
    are never split — a large target gap IS the deletion signal.
    ``q``/``t`` are the aligned base-code arrays (needed to recount
    matches exactly per piece).
    """
    anchors = _match_anchors(aln, q, t, anchor_len)
    if not anchors:
        return [aln]
    groups: List[List[Tuple[int, int]]] = [[anchors[0]]]
    for a in anchors[1:]:
        if a[0] - groups[-1][-1][1] > max_q_gap:
            groups.append([a])
        else:
            groups[-1].append(a)
    if len(groups) == 1:
        return [aln]  # nothing to split; keep edges exactly as aligned
    out: List[Alignment] = []
    for gi, grp in enumerate(groups):
        qs, qe = grp[0][0], grp[-1][1]
        # outer edges keep the original aligned extent (sub-anchor edge
        # wobble stays in its piece) when the extension is small
        if gi == 0 and qs - aln.q_start <= max_q_gap:
            qs = aln.q_start
        if gi == len(groups) - 1 and aln.q_end - qe <= max_q_gap:
            qe = aln.q_end
        piece = _piece_between(aln, q, t, params, qs, qe)
        if piece is not None:
            # split boundaries are not alignment endpoints, so a piece can
            # carry a net-negative junk tail glued to its good block —
            # restore the local-alignment invariant (see _max_score_trim)
            piece = _max_score_trim(piece, q, t, params)
        if piece is not None:
            out.append(piece)
    return out if out else [aln]


def _score_ops(aln: Alignment, params: SWParams) -> int:
    """Score of an alignment's op sequence under ``params`` (affine)."""
    s = aln.matches * params.match - aln.mismatches * params.mismatch
    for op, ln in aln.ops:
        if op in "ID":
            s -= params.gap_open + params.gap_extend * ln
    return s


def rederive_fragmented_gaps(
    aln: Alignment,
    q: np.ndarray,
    t: np.ndarray,
    params: SWParams,
    anchor_len: int = 8,
    min_gap: int = 3,
) -> Alignment:
    """BLAT-parity gap normalization (r4).

    Inside a tandem repeat array the affine DP prefers splitting one
    long deletion into several short unit-matched gaps: the true 89 bp
    deletion (one gap, 0 mismatches) costs 94 while 7D+32D+8D bridged
    by 5M/3M chance unit matches plus 2 impurity mismatches costs less
    under 2/3/5/1 — a fragmented representation whose inter-gap M runs
    are below BLAT's tile anchor and would never appear in a PSL row.
    When an alignment carries >= 2 gaps (len >= ``min_gap``) with any
    inter-gap M run < ``anchor_len``, re-run the host traceback over
    the SAME q/t span with a long-gap-friendly scale (ratios x4,
    gap_extend kept at 1) and adopt the result iff it covers the same
    query span with at least as many matched bases (its score is then
    re-expressed under the caller's params). Winner SELECTION never
    uses the friendly scale — as a default it profitably hops past
    trl junctions via chance anchors (measured r4 regression)."""
    gap_idx = [i for i, (op, ln) in enumerate(aln.ops)
               if op in "ID" and ln >= min_gap]
    if len(gap_idx) < 2:
        return aln
    fragmented = False
    for a, b in zip(gap_idx, gap_idx[1:]):
        between = sum(ln for op, ln in aln.ops[a + 1:b] if op == "M")
        if between < anchor_len:
            fragmented = True
            break
    if not fragmented:
        return aln
    p2 = SWParams(params.match * 4, params.mismatch * 4,
                  params.gap_open * 4, params.gap_extend)
    # the true (unabsorbed) representation spans MORE target than the
    # fragmented one, so re-derive against the whole candidate window —
    # the same-query-span + matches guard below stops any wandering
    sub_q = q[aln.q_start:aln.q_end]
    aln2 = traceback_align(sub_q, t, p2)
    new_score = _score_ops(aln2, params)
    # the re-derivation skips the caller's positive-score guard (it runs
    # after), so a non-positive re-expressed score must never be adopted.
    # The re-derived TARGET span must also overlap the original: inside a
    # long tandem array the x4-scale DP could place its single gap one
    # repeat unit away (representation-ambiguous, but the parity rule must
    # be pinned deterministically — ADVICE r4 #3).
    if (aln2.q_start != 0 or aln2.q_end != len(sub_q)
            or aln2.matches < aln.matches or new_score <= 0
            or aln2.t_start >= aln.t_end or aln2.t_end <= aln.t_start):
        return aln
    return Alignment(
        new_score,
        aln.q_start + aln2.q_start, aln.q_start + aln2.q_end,
        aln2.t_start, aln2.t_end,
        aln2.ops, aln2.matches, aln2.mismatches,
    )


def split_target_gap_junk(
    aln: Alignment,
    q: np.ndarray,
    t: np.ndarray,
    params: SWParams,
    min_t_gap: int = 15,
    min_identity: float = 0.90,
) -> List[Alignment]:
    """Split at deletion-sized TARGET gaps whose flank is junk.

    split_alignment never cuts at target gaps — a large target gap IS
    the deletion signal. But the affine DP will also bridge a
    deletion-sized gap into a PARALOGOUS flank when that outscores
    stopping: a tandem-dup junction inside a dispersed repeat family
    comes back as one segment 96M36D94M whose post-gap side matches the
    ADJACENT family copy at ~84% identity (r4 repeat-genome sweeps,
    dup-called-as-del failures). A real deletion has clean flanks on
    both sides, so the discriminator is per-side identity, not gap
    size: if every gap-delimited side clears ``min_identity`` the
    alignment is kept whole; otherwise it is cut at every gap >=
    ``min_t_gap`` and the junk sides die in the caller's per-piece
    identity filter, leaving the masked requery to place those query
    bases at their true locus."""
    cuts: List[int] = []
    # per-side error tallies are GAP-INCLUSIVE: a paralogous flank the DP
    # threads with several small indels can show clean identity over its
    # M runs alone (the misleading-identity trap split_alignment's
    # docstring warns about). Each sub-threshold gap counts as ONE error
    # EVENT (not its base length): an indel is a single mutation, and
    # per-base counting would split a real deletion whose short flank
    # carries one benign germline indel — the threading signature is
    # SEVERAL small gaps plus scattered mismatches, which event-counting
    # still catches.
    side_gaps: List[int] = [0]
    qpos = aln.q_start
    for op, ln in aln.ops:
        if op in "MI":  # both consume query
            qpos += ln
            if op == "I":
                side_gaps[-1] += 1
        elif ln >= min_t_gap:
            cuts.append(qpos)
            side_gaps.append(0)
        else:
            side_gaps[-1] += 1
    if not cuts:
        return [aln]
    bounds = [aln.q_start] + cuts + [aln.q_end]

    def side_identity(lo: int, hi: int, gap_events: int) -> float:
        m = mm = 0
        for bq, bt, ln in aln.blocks:
            s, e = max(bq, lo), min(bq + ln, hi)
            if e > s:
                off = s - bq
                eq = int(np.sum(q[s:e] == t[bt + off:bt + off + (e - s)]))
                m += eq
                mm += (e - s) - eq
        denom = m + mm + gap_events
        return m / denom if denom else 0.0

    if all(side_identity(bounds[i], bounds[i + 1], side_gaps[i])
           >= min_identity for i in range(len(bounds) - 1)):
        return [aln]
    out: List[Alignment] = []
    for i in range(len(bounds) - 1):
        piece = _piece_between(aln, q, t, params, bounds[i], bounds[i + 1])
        if piece is not None:
            piece = _max_score_trim(piece, q, t, params)
        if piece is not None:
            out.append(piece)
    return out if out else [aln]


def _fill(q: np.ndarray, t: np.ndarray, p: SWParams):
    """Row-vectorized fill of full H/E/F matrices (1-based).

    The in-row E dependence collapses: with go >= ge,
      E[j] = max(H[j-1]-go, E[j-1]-ge) == max_{j'<j} C[j'] - go - ge*(j-1-j')
    where C is the E-free candidate max(0, diag, F) — a single
    ``maximum.accumulate`` per row instead of a sequential scan (the
    stored E equals the recurrent definition, so the traceback's
    E-state checks are unaffected).

    Best-cell selection replays the wavefront tie-break of ops.sw:
    larger H first, then smaller anti-diagonal d=i+j, then smaller i.
    """
    n, m = len(q), len(t)
    H = np.zeros((n + 1, m + 1), dtype=np.int32)
    E = np.full((n + 1, m + 1), NEG, dtype=np.int32)
    F = np.full((n + 1, m + 1), NEG, dtype=np.int32)
    go = p.gap_open + p.gap_extend
    ge = p.gap_extend
    qv = q.astype(np.int32)
    tv = t.astype(np.int32)
    t_bad = tv >= 4
    jj_idx = np.arange(m, dtype=np.int64)
    ge_ramp = ge * jj_idx
    best, bd, bi, bj = 0, 1 << 60, -1, -1
    for i in range(1, n + 1):
        Hp = H[i - 1]
        F[i, 1:] = np.maximum(Hp[1:] - go, F[i - 1, 1:] - ge)
        qc = qv[i - 1]
        if qc >= 4:
            sub = np.full(m, NEG, dtype=np.int64)
        else:
            sub = np.where(t_bad, NEG, np.where(tv == qc, p.match, -p.mismatch))
        C = np.maximum(0, np.maximum(Hp[:-1] + sub, F[i, 1:]))
        S = C + ge_ramp
        pref = np.maximum.accumulate(S)
        E[i, 2:] = pref[:-1] - go - ge_ramp[:-1]
        H[i, 1:] = np.maximum(C, E[i, 1:])
        row = H[i, 1:]
        jj = int(np.argmax(row))  # first max -> smallest j -> smallest d
        val = int(row[jj])
        d = (i - 1) + jj
        if val > best or (val == best and d < bd):
            best, bd, bi, bj = val, d, i - 1, jj
    if best <= 0:
        return H, E, F, 0, -1, -1
    return H, E, F, best, bi, bj


def traceback_align(
    q: np.ndarray, t: np.ndarray, params: SWParams = SWParams(),
    use_native: bool = True,
) -> Alignment:
    """Full local alignment of base-code arrays q vs t.

    Returns a zero-score empty Alignment when nothing aligns. The C++
    fill+traceback (native/breakmer_native.cc nat_sw_traceback) is used
    when available — tested byte-identical to this module's numpy path,
    which remains the oracle and the fallback.
    """
    q = np.asarray(q, dtype=np.int8)
    t = np.asarray(t, dtype=np.int8)
    if len(q) == 0 or len(t) == 0:
        return Alignment(0, 0, 0, 0, 0, [], 0, 0)
    if use_native:
        from breakmer_tpu_torch import native

        res = native.sw_traceback(
            q, t, params.match, params.mismatch,
            params.gap_open, params.gap_extend,
        )
        if res is not None:
            score, q0, q1, t0, t1, matches, mismatches, ops_rev = res
            if score <= 0:
                return Alignment(0, 0, 0, 0, 0, [], 0, 0)
            ops: List[Tuple[str, int]] = []
            for b in reversed(ops_rev):
                op = chr(b)
                if ops and ops[-1][0] == op:
                    ops[-1] = (op, ops[-1][1] + 1)
                else:
                    ops.append((op, 1))
            return Alignment(score, q0, q1, t0, t1, ops, matches, mismatches)
    H, E, F, best, bi, bj = _fill(q, t, params)
    if best <= 0:
        return Alignment(0, 0, 0, 0, 0, [], 0, 0)
    go = params.gap_open + params.gap_extend
    ge = params.gap_extend
    ops_rev: List[str] = []
    matches = mismatches = 0
    i, j = bi + 1, bj + 1  # 1-based
    state = "H"
    while i > 0 and j > 0:
        if state == "H":
            h = H[i, j]
            if h == 0:
                break
            sub = params.match if q[i - 1] == t[j - 1] else -params.mismatch
            if q[i - 1] >= 4 or t[j - 1] >= 4:
                sub = NEG
            if h == H[i - 1, j - 1] + sub:
                ops_rev.append("M")
                if q[i - 1] == t[j - 1]:
                    matches += 1
                else:
                    mismatches += 1
                i -= 1
                j -= 1
            elif h == E[i, j]:
                state = "E"
            elif h == F[i, j]:
                state = "F"
            else:  # pragma: no cover - would indicate a fill bug
                raise AssertionError("traceback: inconsistent H cell")
        elif state == "E":
            ops_rev.append("D")  # consume target
            if E[i, j] == H[i, j - 1] - go:
                state = "H"
            j -= 1
        else:  # F
            ops_rev.append("I")  # consume query
            if F[i, j] == H[i - 1, j] - go:
                state = "H"
            i -= 1
    q_start, t_start = i, j
    # compress ops
    ops: List[Tuple[str, int]] = []
    for op in reversed(ops_rev):
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + 1)
        else:
            ops.append((op, 1))
    return Alignment(
        score=best,
        q_start=q_start,
        q_end=bi + 1,
        t_start=t_start,
        t_end=bj + 1,
        ops=ops,
        matches=matches,
        mismatches=mismatches,
    )
