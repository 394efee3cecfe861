"""Alignment -> SV event classification.

Reference logic being re-implemented (SURVEY.md §2 #13, reference:
sv_caller.py classes sv_event + call/classify fns ~800-1500):

  * one full-coverage gapped alignment within the target => indel calls
    from the alignment's gaps (insertions from query gaps, deletions from
    target gaps) of size >= ``indel_size``;
  * multiple disjoint segments => per-junction classification:
      different chrom                -> translocation ('trl')
      strand flip                    -> rearrangement / inversion
      target order forward, gap      -> rearrangement / deletion
      target order reversed          -> rearrangement / tandem_dup
      contiguous target, query gap   -> rearrangement / ins (novel insert)
    with the +,-,+ three-segment pattern collapsed to a single inversion
    event;
  * per event: genomic breakpoints, split-read support (contig reads
    spanning the junction), discordant-pair support, breakpoint coverage.

Deterministic rules replace the unverifiable reference tie-breaks
(SURVEY.md §7 hard part 1) and are pinned in code + tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from breakmer_tpu_torch.align.realign import AlignSegment
from breakmer_tpu_torch.assemble.greedy import Contig
from breakmer_tpu_torch.call.support import DiscordantPairs, count_split_reads
from breakmer_tpu.config import Config


@dataclasses.dataclass
class SVEvent:
    sv_type: str                  # 'indel' | 'rearrangement' | 'trl'
    sv_subtype: str               # 'I'/'D' | 'del'/'tandem_dup'/'inversion'/'ins' | orientation
    genes: str
    breakpoints: List[Tuple[str, int, Optional[int]]]  # (chrom, start, end|None)
    strands: str
    align_cigar: str
    total_matching: int
    mismatches: int
    size: int
    split_read_count: int
    disc_read_count: int
    breakpoint_coverages: List[int]
    contig_id: str
    contig_seq: str
    segments: List[AlignSegment] = dataclasses.field(default_factory=list)
    filter_reason: Optional[str] = None
    # forward-contig junction coordinates (the breakpoint positions inside
    # contig_seq) — drives the junction-windowed germline normal recheck
    junction_q: List[int] = dataclasses.field(default_factory=list)

    def breakpoints_str(self) -> str:
        out = []
        for chrom, start, end in self.breakpoints:
            if end is not None and end != start:
                out.append(f"{chrom}:{start}-{end}")
            else:
                out.append(f"{chrom}:{start}")
        return ",".join(out)


def _fwd_junction(qpos_oriented: int, strand: str, contig_len: int) -> int:
    """Map a junction coordinate from strand-oriented query space to
    forward contig space (a junction at oriented position p sits between
    bases p-1 and p; in forward space that boundary is at L - p)."""
    return qpos_oriented if strand == "+" else contig_len - qpos_oriented


def _segment_genomic(seg: AlignSegment, window_t: int) -> int:
    """Window-local alignment coordinate -> genomic coordinate."""
    return (seg.t_start - seg.alignment.t_start) + window_t


def _indel_events(
    contig: Contig,
    seg: AlignSegment,
    genes: str,
    cfg: Config,
    coverage_at: Callable[[str, int], int],
) -> List[SVEvent]:
    L = len(contig.seq)
    aln = seg.alignment
    events: List[SVEvent] = []
    for q_pos, t_pos, ln in aln.q_gaps:  # insertions
        if ln < cfg.indel_size:
            continue
        g = _segment_genomic(seg, t_pos)
        if seg.strand == "+":
            f_lo, f_hi = q_pos, q_pos + ln
        else:
            f_lo, f_hi = L - (q_pos + ln), L - q_pos
        # support: reads spanning the whole inserted interval plus margin
        ov = cfg.min_junction_overlap
        sr = sum(
            1
            for r in contig.reads
            if r.offset + ov <= f_lo and f_hi <= r.offset + r.length - ov
        )
        events.append(
            SVEvent(
                sv_type="indel",
                sv_subtype="I",
                genes=genes,
                breakpoints=[(seg.chrom, g, None)],
                strands=seg.strand,
                align_cigar=aln.cigar_string(),
                total_matching=aln.matches,
                mismatches=aln.mismatches,
                size=ln,
                split_read_count=sr,
                disc_read_count=0,
                breakpoint_coverages=[coverage_at(seg.chrom, g)],
                contig_id=contig.id,
                contig_seq=contig.seq,
                segments=[seg],
                junction_q=[f_lo, f_hi],
            )
        )
    for q_pos, t_pos, ln in aln.t_gaps:  # deletions
        if ln < cfg.indel_size:
            continue
        g = _segment_genomic(seg, t_pos)
        jq = _fwd_junction(q_pos, seg.strand, L)
        sr = count_split_reads(contig, jq, cfg.min_junction_overlap)
        events.append(
            SVEvent(
                sv_type="indel",
                sv_subtype="D",
                genes=genes,
                breakpoints=[(seg.chrom, g, g + ln)],
                strands=seg.strand,
                align_cigar=aln.cigar_string(),
                total_matching=aln.matches,
                mismatches=aln.mismatches,
                size=ln,
                split_read_count=sr,
                disc_read_count=0,
                breakpoint_coverages=[
                    coverage_at(seg.chrom, g),
                    coverage_at(seg.chrom, g + ln),
                ],
                contig_id=contig.id,
                contig_seq=contig.seq,
                segments=[seg],
                junction_q=[jq],
            )
        )
    return events


def _junction_bp(seg: AlignSegment, side: str) -> int:
    """Genomic breakpoint of a segment at its query-side junction:
    side='right' means the junction at seg.q_end, side='left' at
    seg.q_start (forward contig orientation)."""
    if seg.strand == "+":
        return seg.t_end if side == "right" else seg.t_start
    return seg.t_start if side == "right" else seg.t_end


def _junction_event(
    contig: Contig,
    a: AlignSegment,
    b: AlignSegment,
    genes: str,
    cfg: Config,
    disc: DiscordantPairs,
    coverage_at: Callable[[str, int], int],
) -> Optional[SVEvent]:
    L = len(contig.seq)
    bp1 = (a.chrom, _junction_bp(a, "right"))
    bp2 = (b.chrom, _junction_bp(b, "left"))
    q_gap = b.q_start - a.q_end
    # split reads must span from the end of a into the start of b
    ov = cfg.min_junction_overlap
    lo = min(a.q_end, b.q_start)
    hi = max(a.q_end, b.q_start)
    sr = sum(
        1
        for r in contig.reads
        if r.offset + ov <= lo and hi <= r.offset + r.length - ov
    )
    disc_n = disc.support(bp1, bp2, cfg.disc_pair_window)
    strands = f"{a.strand}/{b.strand}"
    cigar = f"{a.alignment.cigar_string()};{b.alignment.cigar_string()}"
    common = dict(
        genes=genes,
        strands=strands,
        align_cigar=cigar,
        total_matching=a.matches + b.matches,
        mismatches=a.mismatches + b.mismatches,
        split_read_count=sr,
        disc_read_count=disc_n,
        contig_id=contig.id,
        contig_seq=contig.seq,
        segments=[a, b],
        junction_q=[lo, hi],
    )
    cov = [coverage_at(*bp1), coverage_at(*bp2)]
    if a.chrom != b.chrom:
        return SVEvent(
            sv_type="trl",
            sv_subtype=strands,
            breakpoints=[(*bp1, None), (*bp2, None)],
            size=0,
            breakpoint_coverages=cov,
            **common,
        )
    if a.strand != b.strand:
        return SVEvent(
            sv_type="rearrangement",
            sv_subtype="inversion",
            breakpoints=[(*bp1, None), (*bp2, None)],
            size=abs(bp2[1] - bp1[1]),
            breakpoint_coverages=cov,
            **common,
        )
    # same chrom, same strand: orientation-aware skipped-target distance
    if a.strand == "+":
        delta = b.t_start - a.t_end
    else:
        delta = a.t_start - b.t_end
    if delta >= cfg.indel_size:
        lo_g, hi_g = sorted((bp1[1], bp2[1]))
        return SVEvent(
            sv_type="rearrangement",
            sv_subtype="del",
            breakpoints=[(a.chrom, lo_g, hi_g)],
            size=delta,
            breakpoint_coverages=cov,
            **common,
        )
    if delta <= -cfg.indel_size:
        dup_lo = min(b.t_start, b.t_end, a.t_start, a.t_end)
        if a.strand == "+":
            dup_lo, dup_hi = b.t_start, a.t_end
        else:
            dup_lo, dup_hi = a.t_start, b.t_end
        return SVEvent(
            sv_type="rearrangement",
            sv_subtype="tandem_dup",
            breakpoints=[(a.chrom, dup_lo, dup_hi)],
            size=abs(delta),
            breakpoint_coverages=cov,
            **common,
        )
    if q_gap >= cfg.indel_size:
        return SVEvent(
            sv_type="rearrangement",
            sv_subtype="ins",
            breakpoints=[(*bp1, None)],
            size=q_gap,
            breakpoint_coverages=[cov[0]],
            **common,
        )
    return None  # contiguous — no event at this junction


def classify_contig(
    contig: Contig,
    segments: Sequence[AlignSegment],
    genes: str,
    cfg: Config,
    disc: Optional[DiscordantPairs] = None,
    coverage_at: Optional[Callable[[str, int], int]] = None,
) -> List[SVEvent]:
    """Classify one contig's realignment into SV events (unfiltered;
    the filter stack runs separately — call/filters.py)."""
    disc = disc or DiscordantPairs()
    coverage_at = coverage_at or (lambda chrom, pos: 0)
    segments = sorted(segments, key=lambda s: (s.q_start, s.q_end))
    if not segments:
        return []
    L = len(contig.seq)
    if len(segments) == 1:
        return _indel_events(contig, segments[0], genes, cfg, coverage_at)

    events: List[SVEvent] = []
    # indels inside individual segments still count (e.g. a small indel in
    # one arm of a translocation contig)
    for seg in segments:
        events.extend(_indel_events(contig, seg, genes, cfg, coverage_at))

    # three-segment inversion pattern: +,-,+ or -,+,- on one chrom
    if (
        len(segments) == 3
        and len({s.chrom for s in segments}) == 1
        and segments[0].strand == segments[2].strand
        and segments[0].strand != segments[1].strand
    ):
        mid = segments[1]
        inv_lo, inv_hi = sorted((mid.t_start, mid.t_end))
        sr = min(
            count_split_reads(contig, segments[0].q_end, cfg.min_junction_overlap),
            count_split_reads(contig, segments[1].q_end, cfg.min_junction_overlap),
        )
        events.append(
            SVEvent(
                sv_type="rearrangement",
                sv_subtype="inversion",
                genes=genes,
                breakpoints=[(mid.chrom, inv_lo, inv_hi)],
                strands="/".join(s.strand for s in segments),
                align_cigar=";".join(s.alignment.cigar_string() for s in segments),
                total_matching=sum(s.matches for s in segments),
                mismatches=sum(s.mismatches for s in segments),
                size=inv_hi - inv_lo,
                split_read_count=sr,
                disc_read_count=(disc.support(
                    (mid.chrom, inv_lo), (mid.chrom, inv_hi), cfg.disc_pair_window
                ) if disc else 0),
                breakpoint_coverages=[
                    coverage_at(mid.chrom, inv_lo),
                    coverage_at(mid.chrom, inv_hi),
                ],
                contig_id=contig.id,
                contig_seq=contig.seq,
                segments=list(segments),
                junction_q=[segments[0].q_end, segments[1].q_end],
            )
        )
        return events

    for a, b in zip(segments, segments[1:]):
        ev = _junction_event(contig, a, b, genes, cfg, disc, coverage_at)
        if ev is not None:
            events.append(ev)
    return events
