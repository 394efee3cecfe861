"""The SV-call filter stack.

Reference: sv_caller.py ~1500-1800 + utils rmask (SURVEY.md §2 #14).
Filters set ``filter_reason`` on failing events (kept for observability —
the reference logs rejections as prose; here they are structured) and
``apply_filters`` returns only passing events.

Thresholds (all Config knobs, reference names kept):
  repeat overlap fraction  > max_repeat_frac     (skip if keep_repeat_regions)
  segment length           < rearr_min_seg_len / trl_min_seg_len
  split-read support       < indel_sr_thresh / rearr_sr_thresh / trl_sr_thresh
  translocation disc pairs < min_disc_reads
  contig complexity        < min_complexity
  intron-only breakpoints  (skip if keep_intron_vars)
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from breakmer_tpu_torch.call.events import SVEvent
from breakmer_tpu.config import Config
from breakmer_tpu.io.bed import TargetRegion
from breakmer_tpu.utils.complexity import contig_complexity
from breakmer_tpu.utils.rmask import RepeatMask


def _sr_thresh(cfg: Config, sv_type: str) -> int:
    return {
        "indel": cfg.indel_sr_thresh,
        "rearrangement": cfg.rearr_sr_thresh,
        "trl": cfg.trl_sr_thresh,
    }[sv_type]


def _min_seg_len(cfg: Config, sv_type: str) -> Optional[int]:
    if sv_type == "trl":
        return cfg.trl_min_seg_len
    if sv_type == "rearrangement":
        return cfg.rearr_min_seg_len
    return None


def _in_intron_only(ev: SVEvent, target: Optional[TargetRegion]) -> bool:
    """True iff every breakpoint falls inside an interval annotated as
    intron (reference: within-intron filtering, keyed on the BED feature
    column — SURVEY.md §2 #16)."""
    if target is None:
        return False
    intron_ivs = [
        iv for iv in target.intervals if (iv.feature or "").lower() == "intron"
    ]
    if not intron_ivs:
        return False
    for chrom, start, end in ev.breakpoints:
        for pos in (start, end if end is not None else start):
            inside = any(
                iv.chrom == chrom and iv.start <= pos < iv.end for iv in intron_ivs
            )
            if not inside:
                return False
    return True


def check_event(
    ev: SVEvent,
    cfg: Config,
    rmask: Optional[RepeatMask] = None,
    target: Optional[TargetRegion] = None,
    user_filter: Optional[RepeatMask] = None,
) -> Optional[str]:
    """Returns a rejection reason or None if the event passes.

    ``user_filter`` is the reference's filter_list (SURVEY.md §2 #14
    [UNCERTAIN exact semantics] — pinned here as: suppress any event with
    a breakpoint inside a listed interval)."""
    if user_filter is not None:
        for chrom, start, end in ev.breakpoints:
            for pos in (start,) + ((end,) if end is not None else ()):
                if user_filter.contains(chrom, pos):
                    return f"user_filter:{chrom}:{pos}"
    if ev.split_read_count < _sr_thresh(cfg, ev.sv_type):
        return (
            f"split_read_support:{ev.split_read_count}<"
            f"{_sr_thresh(cfg, ev.sv_type)}"
        )
    msl = _min_seg_len(cfg, ev.sv_type)
    if msl is not None and ev.segments:
        shortest = min(s.q_span for s in ev.segments)
        if shortest < msl:
            return f"min_segment_len:{shortest}<{msl}"
    if ev.sv_type == "trl" and ev.disc_read_count < cfg.min_disc_reads:
        return f"disc_read_support:{ev.disc_read_count}<{cfg.min_disc_reads}"
    comp = contig_complexity(ev.contig_seq)
    if comp < cfg.min_complexity:
        return f"low_complexity:{comp:.3f}<{cfg.min_complexity}"
    if rmask is not None and not cfg.keep_repeat_regions and ev.segments:
        for seg in ev.segments:
            frac = rmask.overlap_fraction(seg.chrom, seg.t_start, seg.t_end)
            seg.repeat_frac = frac
            if frac > cfg.max_repeat_frac:
                # placement-uniqueness rescue: the realigner recorded the
                # best score any DISJOINT locus achieved for this segment
                # (second_score, -1 = unknown -> no rescue). When no
                # competing placement comes close, the repeat annotation
                # alone does not make the mapping ambiguous — reject only
                # truly multi-mapping anchors (config.repeat_uniq_rescue).
                # The ratio test runs on the ROUND-winner scale: pieces
                # split out of one winner traceback inherit the round's
                # second_score, so comparing against the (smaller) piece
                # score under-fires the rescue on correctly-unique small
                # pieces (ADVICE r4 #2).
                second = getattr(seg, "second_score", -1)
                winner = getattr(seg, "round_score", -1)
                if winner <= 0:
                    winner = seg.score
                if (
                    cfg.repeat_uniq_rescue
                    and second >= 0
                    and winner > 0
                    and second <= cfg.repeat_uniq_ratio * winner
                ):
                    continue
                return f"repeat_overlap:{frac:.2f}>{cfg.max_repeat_frac}"
    if not cfg.keep_intron_vars and _in_intron_only(ev, target):
        return "intron_only"
    return None


def apply_filters(
    events: Sequence[SVEvent],
    cfg: Config,
    rmask: Optional[RepeatMask] = None,
    target: Optional[TargetRegion] = None,
    user_filter: Optional[RepeatMask] = None,
) -> List[SVEvent]:
    """Annotate every event with its filter outcome; return the passers."""
    passed: List[SVEvent] = []
    for ev in events:
        reason = check_event(ev, cfg, rmask, target, user_filter)
        ev.filter_reason = reason
        if reason is None:
            passed.append(ev)
    return passed
