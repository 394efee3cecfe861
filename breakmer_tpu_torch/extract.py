"""SV-informative read extraction and cleaning.

Reference: sv_processor.py target.extract_bam_reads (SURVEY.md §2 #6) —
pysam fetch over the region keeping reads that are soft-clipped (clip
length and clip base-quality thresholds), unmapped-with-mapped-mate,
mate-unmapped, or discordant (mate on another chrom / abnormal insert /
abnormal orientation), writing an sv-reads fastq and recording discordant
pairs keyed by mate chrom; plus target.clean_reads (SURVEY.md §2 #8) which
shells out to cutadapt.

Here extraction consumes parsed alignment records (io.sam / io.bam) and
produces a packed ReadBatch + DiscordantPairs + a region coverage array
directly — no fastq round-trip. Cleaning is a vectorized quality trim
(the cutadapt-config subset the reference pipeline actually used: quality
trimming + minimum length).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

import numpy as np

from breakmer_tpu_torch.call.support import DiscordantPairs
from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.encode import ReadBatch
from breakmer_tpu_torch.io.bam_ingest import RowFields
from breakmer_tpu_torch.io.sam import SamRecord


@dataclasses.dataclass
class ExtractResult:
    batch: ReadBatch              # SV-informative reads (packed)
    disc: DiscordantPairs
    coverage: np.ndarray          # depth over [region_start, region_end)
    region_chrom: str
    region_start: int
    n_records: int                # records scanned
    n_sv_reads: int

    def coverage_at(self, chrom: str, pos: int) -> int:
        if chrom != self.region_chrom:
            return 0
        i = pos - self.region_start
        if 0 <= i < len(self.coverage):
            return int(self.coverage[i])
        return 0


def _clip_quals_ok(rec: SamRecord, side: str, clip_len: int, min_qual: float) -> bool:
    if not rec.qual:
        return True
    if side == "left":
        seg = rec.qual[:clip_len]
    else:
        seg = rec.qual[-clip_len:]
    return (sum(seg) / len(seg)) >= min_qual if seg else True


def is_sv_informative(rec: SamRecord, cfg: Config) -> Tuple[bool, Optional[str]]:
    """(keep, reason). Reasons: softclip / unmapped / mate_unmapped /
    discordant. Mirrors the reference's keep-classes (SURVEY.md §2 #6)."""
    if rec.is_secondary or rec.is_supplementary or rec.is_dup:
        return False, None
    if rec.is_unmapped:
        return True, "unmapped"
    left, right = rec.soft_clips()
    if left >= cfg.min_clip_len and _clip_quals_ok(rec, "left", left, cfg.min_clip_qual):
        return True, "softclip"
    if right >= cfg.min_clip_len and _clip_quals_ok(rec, "right", right, cfg.min_clip_qual):
        return True, "softclip"
    if rec.is_paired and rec.mate_unmapped:
        return True, "mate_unmapped"
    if rec.is_paired and not rec.mate_unmapped:
        if rec.rnext != rec.rname:
            return True, "discordant"
        if abs(rec.tlen) > cfg.insert_size_thresh:
            return True, "discordant"
        if rec.is_reverse == rec.mate_reverse:
            return True, "discordant"
    return False, None


def extract_sv_reads(
    records: Iterable[SamRecord],
    region: Tuple[str, int, int],
    cfg: Config,
) -> ExtractResult:
    """One pass over region records: classify, pack, count coverage."""
    chrom, start, end = region
    cov = np.zeros(max(1, end - start), dtype=np.int32)
    seqs: List[str] = []
    names: List[str] = []
    quals: List[List[int]] = []
    disc = DiscordantPairs()
    n_records = 0
    seen_names = set()
    for rec in records:
        n_records += 1
        if not rec.is_unmapped and not rec.is_secondary and not rec.is_supplementary:
            cl, cr = rec.soft_clips() if cfg.clip_coverage else (0, 0)
            lo = max(0, rec.pos - cl - start)
            hi = min(end - start, rec.reference_end() + cr - start)
            if hi > lo:
                cov[lo:hi] += 1
        keep, reason = is_sv_informative(rec, cfg)
        if not keep:
            continue
        if reason == "discordant":
            disc.add(rec.rname, rec.pos, rec.rnext, rec.pnext)
        # unique name per mate (reference appends /1 /2 from flags)
        mate_tag = "/2" if rec.flag & 0x80 else "/1"
        name = rec.qname + mate_tag
        if name in seen_names or not rec.seq or rec.seq == "*":
            continue
        seen_names.add(name)
        seqs.append(rec.seq)
        names.append(name)
        quals.append(rec.qual if rec.qual else [40] * len(rec.seq))
    batch = (
        ReadBatch.from_seqs(seqs, names=names, quals=quals)
        if seqs
        else ReadBatch.from_seqs([])
    )
    return ExtractResult(
        batch=batch,
        disc=disc,
        coverage=cov,
        region_chrom=chrom,
        region_start=start,
        n_records=n_records,
        n_sv_reads=len(seqs),
    )


def _region_row_idx(cols: dict, rid: int, start: int, end: int) -> np.ndarray:
    """File-order indices of records overlapping [start, end) on refid
    ``rid``. Per-refid (file-order indices sorted by pos, sorted pos, max
    extent) built once and cached on the cols dict: per-region
    full-column overlap masks were O(regions x records) and dominated
    extraction at panel scale. A record at sorted pos p can only overlap
    [start, end) if start - max_extent <= p < end, so the searchsorted
    window plus an exact test on the few candidates reproduces the full
    scan."""
    flag = cols["flag"]
    pos = cols["pos"]
    span = cols["ref_span"]
    refid = cols["refid"]
    bins = cols.get("_region_bins")
    if bins is None:
        unmapped_all = (flag & 0x4) != 0
        eff_end = np.where(unmapped_all, pos + 1, pos + span)
        bins = {}
        for r in np.unique(refid):
            if r < 0:
                continue
            ridx = np.nonzero(refid == r)[0]
            order = ridx[np.argsort(pos[ridx], kind="stable")]
            psort = pos[order]
            ext = int((eff_end[order] - psort).max()) if len(order) else 0
            bins[int(r)] = (order, psort, ext)
        cols["_region_bins"] = bins
    entry = bins.get(rid)
    if entry is None:
        return np.zeros(0, dtype=np.int64)
    order, psort, ext = entry
    lo_i = int(np.searchsorted(psort, start - ext, "left"))
    hi_i = int(np.searchsorted(psort, end, "left"))
    cand = order[lo_i:hi_i]
    um_c = (flag[cand] & 0x4) != 0
    p_c = pos[cand]
    sp_c = span[cand]
    hit = np.where(
        um_c,
        (p_c >= start) & (p_c < end),
        (p_c < end) & (p_c + sp_c > start),
    )
    return np.sort(cand[hit])  # restore file order (the full scan's order)


def _clip_quality_passes(fields: RowFields, rows: np.ndarray, cl: np.ndarray, cr: np.ndarray,
                         lseq: np.ndarray, width: int, cfg: Config) -> np.ndarray:
    """The soft-clip test of ``is_sv_informative`` on ``rows`` (with their
    clip lengths and read lengths): a clip at least ``min_clip_len`` long
    whose bases average at least ``min_clip_qual``. The qualities come at
    ``width``, the file's longest read, so each average divides as the
    whole-file columns did."""
    quals = fields.gather(rows, width, quals=True).quals
    ml = np.maximum(cl, 1)
    mr = np.maximum(cr, 1)
    col_ix = np.arange(quals.shape[1])
    left_mask = col_ix[None, :] < ml[:, None]
    right_lo = lseq - mr
    right_mask = (col_ix[None, :] >= right_lo[:, None]) & (col_ix[None, :] < lseq[:, None])
    q = np.where(quals >= 0, quals, 0)
    left_avg = (q * left_mask).sum(1) / np.maximum(left_mask.sum(1), 1)
    right_avg = (q * right_mask).sum(1) / np.maximum(right_mask.sum(1), 1)
    return (((cl >= cfg.min_clip_len) & (left_avg >= cfg.min_clip_qual))
            | ((cr >= cfg.min_clip_len) & (right_avg >= cfg.min_clip_qual)))


def extract_sv_reads_columnar(
    cols: dict,
    fields: RowFields,
    ref_names: List[str],
    region: Tuple[str, int, int],
    cfg: Config,
) -> ExtractResult:
    """Columnar twin of :func:`extract_sv_reads` over a sample's
    fixed-width columns (``io/bam_ingest.py``): per-region classification
    is vectorized numpy over the columns, and ``fields`` decodes the
    variable-width fields of the rows that need them (the clip candidates'
    qualities, the kept reads). Produces byte-identical ExtractResults to
    the record path (tested).

    Classification priority replicates is_sv_informative exactly:
    unmapped > softclip > mate_unmapped > discordant — in particular a
    soft-clipped discordant read is "softclip" and does NOT enter the
    discordant-pair map.
    """
    chrom, start, end = region
    rid = ref_names.index(chrom) if chrom in ref_names else -1
    n = cols["n"]
    cov = np.zeros(max(1, end - start), dtype=np.int32)
    disc = DiscordantPairs()
    empty = ExtractResult(
        batch=ReadBatch.from_seqs([]), disc=disc, coverage=cov,
        region_chrom=chrom, region_start=start, n_records=0, n_sv_reads=0,
    )
    if n == 0 or rid < 0:
        return empty
    flag = cols["flag"]
    pos = cols["pos"]
    span = cols["ref_span"]
    refid = cols["refid"]
    idx = _region_row_idx(cols, rid, start, end)
    if len(idx) == 0:
        return empty
    f = flag[idx]
    p = pos[idx]
    sp = span[idx]
    um = (f & 0x4) != 0
    secondary = (f & (0x100 | 0x800)) != 0
    dup = (f & 0x400) != 0
    # coverage over all mapped primary records (duplicates included, as in
    # the record path)
    covered = ~um & ~secondary
    ccl = cols["clip_left"][idx] if cfg.clip_coverage else np.zeros(len(idx), np.int64)
    ccr = cols["clip_right"][idx] if cfg.clip_coverage else np.zeros(len(idx), np.int64)
    # interval-stabbing depth: +1/-1 boundary marks counted by bincount,
    # then cumsum (the per-record python slice loop was most of this
    # function's time, and np.add.at half of what was left)
    clo = np.maximum(0, p[covered] - ccl[covered] - start)
    chi = np.minimum(end - start, p[covered] + sp[covered] + ccr[covered] - start)
    ok = chi > clo
    if ok.any():
        bound = (np.bincount(clo[ok], minlength=len(cov) + 1)
                 - np.bincount(chi[ok], minlength=len(cov) + 1))
        cov += np.cumsum(bound[:-1], dtype=np.int32)
    considered = ~secondary & ~dup
    paired = (f & 0x1) != 0
    mate_unmapped = (f & 0x8) != 0
    reverse = (f & 0x10) != 0
    mate_reverse = (f & 0x20) != 0
    cl = cols["clip_left"][idx]
    cr = cols["clip_right"][idx]
    lseq = cols["lseq"][idx]
    # clip base-quality gate (avg >= min_clip_qual), only over rows whose
    # clip is long enough to matter: rows failing both length gates can
    # never be softclip regardless of their averages
    softclip = np.zeros(len(idx), dtype=bool)
    cand_clip = np.nonzero(
        considered & ~um
        & ((cl >= cfg.min_clip_len) | (cr >= cfg.min_clip_len))
    )[0]
    if len(cand_clip):
        softclip[cand_clip] = _clip_quality_passes(
            fields, idx[cand_clip], cl[cand_clip], cr[cand_clip], lseq[cand_clip],
            cols["max_seq"], cfg)
    keep_unmapped = considered & um
    keep_mate_um = considered & ~um & ~softclip & paired & mate_unmapped
    tlen = cols["tlen"][idx]
    nrefid = cols["next_refid"][idx]
    discordant = (
        considered & ~um & ~softclip & ~keep_mate_um & paired
        & (
            (nrefid != refid[idx])
            | (np.abs(tlen) > cfg.insert_size_thresh)
            | (reverse == mate_reverse)
        )
    )
    keep = keep_unmapped | softclip | keep_mate_um | discordant
    # discordant-pair map
    npos = cols["next_pos"][idx]
    for i in np.nonzero(discordant)[0]:
        nrid = int(nrefid[i])
        disc.add(
            chrom, int(p[i]),
            ref_names[nrid] if 0 <= nrid < len(ref_names) else "*",
            int(npos[i]),
        )
    # pack kept reads (dedup by name+mate like the record path). The
    # gathered rows come in ReadBatch's layout (codes PAD=4 beyond length,
    # quals -1 pad), so they go in as they are where no name repeats
    names: List[str] = []
    rows: List[int] = []
    kept = np.nonzero(keep & (lseq > 0))[0]
    if len(kept):
        got = fields.gather(idx[kept], int(lseq[kept].max()), codes=True, quals=True, names=True)
        seen = set()
        for j, (i, base) in enumerate(zip(kept.tolist(), got.names)):
            name = base + ("/2" if f[i] & 0x80 else "/1")
            if name in seen:
                continue
            seen.add(name)
            names.append(name)
            rows.append(j)
        lens = lseq[kept[rows]].astype(np.int32)
        codes, quals = got.codes, got.quals
        if len(rows) < len(kept):
            lmax = int(lens.max())
            codes = np.ascontiguousarray(codes[rows, :lmax])
            quals = np.ascontiguousarray(quals[rows, :lmax])
        batch = ReadBatch(codes=codes, lengths=lens, names=names, quals=quals)
    else:
        batch = ReadBatch.from_seqs([])
    return ExtractResult(
        batch=batch, disc=disc, coverage=cov, region_chrom=chrom,
        region_start=start, n_records=int(len(idx)), n_sv_reads=len(rows),
    )


def extract_all_reads(
    records: Iterable[SamRecord],
    region: Tuple[str, int, int],
) -> ReadBatch:
    """EVERY primary region read (clean-mapped included) as a ReadBatch —
    the contig-extension read pool (assemble/extend.py): inside repeat
    arrays the informative flanking molecules align cleanly and are
    correctly absent from extract_sv_reads' batch. Secondary /
    supplementary / duplicate records and seq-less rows are skipped;
    otherwise no filtering (extension's consensus vote is the filter)."""
    seqs: List[str] = []
    for rec in records:
        if rec.is_secondary or rec.is_supplementary or rec.is_dup:
            continue
        if not rec.seq or rec.seq == "*":
            continue
        seqs.append(rec.seq)
    return ReadBatch.from_seqs(seqs)


def extract_all_reads_columnar(
    cols: dict,
    fields: RowFields,
    ref_names: List[str],
    region: Tuple[str, int, int],
) -> ReadBatch:
    """Columnar twin of :func:`extract_all_reads` (the columns of
    ``io/bam_ingest.py``, the pool's reads gathered through ``fields``);
    byte-identical codes/lengths content on identical region streams."""
    chrom, start, end = region
    rid = ref_names.index(chrom) if chrom in ref_names else -1
    if cols["n"] == 0 or rid < 0:
        return ReadBatch.from_seqs([])
    idx = _region_row_idx(cols, rid, start, end)
    if len(idx) == 0:
        return ReadBatch.from_seqs([])
    f = cols["flag"][idx]
    lseq = cols["lseq"][idx]
    keep = ((f & (0x100 | 0x800 | 0x400)) == 0) & (lseq > 0)
    sel = idx[keep]
    if not len(sel):
        return ReadBatch.from_seqs([])
    lens = cols["lseq"][sel].astype(np.int32)
    got = fields.gather(sel, int(lens.max()), codes=True, quals=True)
    return ReadBatch(codes=got.codes, lengths=lens, names=[f"r{int(i)}" for i in sel],
                     quals=got.quals)


def global_discordant_pairs(
    records: Iterable[SamRecord], cfg: Config
) -> DiscordantPairs:
    """Run-level discordant-pair map over the WHOLE sample (one pass).

    The per-region map only sees pairs whose anchor read falls inside the
    region window, so a junction whose supporting pairs anchor just
    outside the window (or in the translocation partner locus) loses that
    evidence — a reference blind spot (its per-target dict has the same
    one; VERDICT r1 weak #7) fixed here behind cfg.global_disc_support.

    Classification priority matches is_sv_informative exactly (a
    soft-clipped discordant read is "softclip" and does not enter the
    map). Entries are deduplicated by qname — one entry per PAIR — where
    the per-region map records one entry per discordant RECORD (both
    mates in-region => two entries); global counts are therefore
    per-pair, documented at the config knob.
    """
    disc = DiscordantPairs()
    seen: set = set()
    for rec in records:
        keep, reason = is_sv_informative(rec, cfg)
        if reason != "discordant" or rec.qname in seen:
            continue
        seen.add(rec.qname)
        disc.add(rec.rname, rec.pos, rec.rnext, rec.pnext)
    return disc


def global_discordant_pairs_columnar(
    cols: dict, fields: RowFields, ref_names: List[str], cfg: Config
) -> DiscordantPairs:
    """Columnar twin of :func:`global_discordant_pairs` over a sample's
    columns: whole-file vectorized classification, the qualities gathered
    only for rows whose clip is long enough to pass and the names only for
    the discordant rows; identical entries (tested against the record
    path)."""
    disc = DiscordantPairs()
    n = cols.get("n", 0)
    if not n:
        return disc
    flag = cols["flag"]
    um = (flag & 0x4) != 0
    secondary = (flag & (0x100 | 0x800)) != 0
    dup = (flag & 0x400) != 0
    considered = ~secondary & ~dup
    paired = (flag & 0x1) != 0
    mate_unmapped = (flag & 0x8) != 0
    reverse = (flag & 0x10) != 0
    mate_reverse = (flag & 0x20) != 0
    cl = cols["clip_left"]
    cr = cols["clip_right"]
    softclip = np.zeros(n, dtype=bool)
    cand = np.flatnonzero(considered & ~um & ((cl >= cfg.min_clip_len) | (cr >= cfg.min_clip_len)))
    if len(cand):
        softclip[cand] = _clip_quality_passes(fields, cand, cl[cand], cr[cand],
                                              cols["lseq"][cand], cols["max_seq"], cfg)
    keep_mate_um = considered & ~um & ~softclip & paired & mate_unmapped
    refid = cols["refid"]
    nrefid = cols["next_refid"]
    tlen = cols["tlen"]
    discordant = (
        considered & ~um & ~softclip & ~keep_mate_um & paired
        & (
            (nrefid != refid)
            | (np.abs(tlen) > cfg.insert_size_thresh)
            | (reverse == mate_reverse)
        )
    )
    pos = cols["pos"]
    npos = cols["next_pos"]
    rows = np.flatnonzero(discordant)
    qnames = fields.gather(rows, names=True).names if len(rows) else []
    seen: set = set()
    for i, qname in zip(rows.tolist(), qnames):
        if qname in seen:
            continue
        seen.add(qname)
        rid = int(refid[i])
        nrid = int(nrefid[i])
        disc.add(
            ref_names[rid] if 0 <= rid < len(ref_names) else "*",
            int(pos[i]),
            ref_names[nrid] if 0 <= nrid < len(ref_names) else "*",
            int(npos[i]),
        )
    return disc


def _semiglobal_dp(seq_arr: np.ndarray, pattern: np.ndarray) -> np.ndarray:
    """Edit-distance DP of ``pattern`` (rows) vs ``seq`` (cols) with FREE
    text start: D[i, j] = min unit-cost edits (mismatch / insertion /
    deletion) aligning pattern[:i] to some substring of seq ending at j.
    Row-vectorized: the in-row left dependence D[i,j-1]+1 collapses to a
    minimum.accumulate over (candidate - j) + j. (m+1) x (n+1) int32 —
    adapters are <= ~35 bp, so the whole matrix is a few KB per read."""
    m, n = len(pattern), len(seq_arr)
    D = np.empty((m + 1, n + 1), dtype=np.int32)
    D[0] = 0
    jj = np.arange(n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        sub = (seq_arr != pattern[i - 1]).astype(np.int32)
        cand = np.empty(n + 1, dtype=np.int32)
        cand[0] = i  # D[i][0] = i (pattern chars deleted)
        cand[1:] = np.minimum(D[i - 1, :-1] + sub, D[i - 1, 1:] + 1)
        D[i] = np.minimum.accumulate(cand - jj) + jj
    return D


def _traceback_start(D: np.ndarray, seq_arr: np.ndarray,
                     pattern: np.ndarray, i: int, j: int):
    """(start, matches) of one optimal alignment of pattern[:i] ending at
    seq position j. Deterministic preference: diagonal, then up (pattern
    gap), then left (text gap) — pins the tie-break like every other
    parity rule."""
    matches = 0
    while i > 0:
        here = D[i, j]
        if j > 0 and D[i - 1, j - 1] + (seq_arr[j - 1] != pattern[i - 1]) == here:
            if seq_arr[j - 1] == pattern[i - 1]:
                matches += 1
            i -= 1
            j -= 1
        elif D[i - 1, j] + 1 == here:
            i -= 1
        else:
            j -= 1
    return j, matches


def _find_adapter_3p(
    seq: str, adapter: str, min_overlap: int = 3, error_rate: float = 0.1
) -> int:
    """cutadapt-style 3' adapter location: the adapter (or an
    adapter-prefix overlapping the read's 3' end) may match with up to
    floor(error_rate * matched_adapter_len) ERRORS, where an error is a
    mismatch OR an indel — the full cutadapt alignment model (the r1
    matcher was Hamming-only; VERDICT r1 missing #5), via a semi-global
    edit DP over the <= ~35 bp adapter. Among candidates the best is
    most matching bases, then fewest errors, then leftmost — cutadapt's
    ranking. Returns the cut position, or len(seq) if no match."""
    n, alen = len(seq), len(adapter)
    if n < min_overlap or alen == 0:
        return n
    seq_arr = np.frombuffer(seq.encode(), dtype=np.uint8)
    pat = np.frombuffer(adapter.encode(), dtype=np.uint8)
    D = _semiglobal_dp(seq_arr, pat)
    cands = []  # (pattern_len i, end j)
    allowed_full = int(error_rate * alen)
    for j in np.nonzero(D[alen, 1:] <= allowed_full)[0] + 1:
        cands.append((alen, int(j)))
    # adapter prefix overlapping the 3' end: alignment must end at j == n
    for i in range(min_overlap, alen):
        if D[i, n] <= int(error_rate * i):
            cands.append((i, n))
    best = None  # (-matches, errors, cut)
    for i, j in cands:
        start, matches = _traceback_start(D, seq_arr, pat, i, j)
        key = (-matches, int(D[i, j]), start)
        if best is None or key < best:
            best = key
    return best[2] if best is not None else n


def _find_adapter_5p(
    seq: str, adapter: str, min_overlap: int = 3, error_rate: float = 0.1
) -> int:
    """cutadapt -g (non-anchored 5') analog: the full adapter near the
    read start, or an adapter-suffix overlapping the read's 5' end; trims
    through the adapter's last base. Same indel-tolerant error model and
    ranking as the 3' matcher, run in mirrored (reversed) space so the
    free-text-start DP serves the free-text-END geometry. Returns the
    first kept position (0 = no match)."""
    n, alen = len(seq), len(adapter)
    if n < min_overlap or alen == 0:
        return 0
    seq_r = np.frombuffer(seq.encode(), dtype=np.uint8)[::-1].copy()
    pat_r = np.frombuffer(adapter.encode(), dtype=np.uint8)[::-1].copy()
    D = _semiglobal_dp(seq_r, pat_r)
    cands = []
    allowed_full = int(error_rate * alen)
    # full adapter: keep the pre-existing "within the first few bases of
    # the read" restriction => reversed end j >= n - 3 - (edit slack)
    for j in np.nonzero(D[alen, 1:] <= allowed_full)[0] + 1:
        cands.append((alen, int(j)))
    for i in range(min_overlap, alen):
        if D[i, n] <= int(error_rate * i):
            cands.append((i, n))
    best = None  # (-matches, errors, cut)
    for i, j in cands:
        start_r, matches = _traceback_start(D, seq_r, pat_r, i, j)
        if i == alen and n - j > 3:
            continue  # internal full adapter must sit near the read start
        cut = n - start_r  # original-space end of the adapter occurrence
        key = (-matches, int(D[i, j]), cut)
        if best is None or key < best:
            best = key
    return best[2] if best is not None else 0


def _quality_trim_batch(batch: ReadBatch, trim_qual: int, min_len: int) -> ReadBatch:
    """Vectorized twin of the no-adapter clean_reads path: cutadapt's
    partial-sum quality trim applied to the whole [R, L] batch at once
    (the per-read loop was ~1.3 ms/region of warm panel time). Matches
    the loop exactly: cumsum of (trim_qual - q) from each end, cut at the
    FIRST maximum when positive (np.argmax tie rule), drop reads shorter
    than min_len after trimming."""
    lens = batch.lengths.astype(np.int64)
    R, L = batch.quals.shape
    col = np.arange(L)
    valid = col[None, :] < lens[:, None]
    q = np.where(valid, batch.quals, 0).astype(np.int64)
    NEG = np.int64(-1) << 40  # plunges the cumsum at the first pad position
    d5 = np.where(valid, trim_qual - q, NEG)
    s5 = np.cumsum(d5, axis=1)
    cut5 = np.where(s5.max(axis=1) > 0, s5.argmax(axis=1) + 1, 0)
    rev_ix = np.clip(lens[:, None] - 1 - col[None, :], 0, max(L - 1, 0))
    d3 = np.where(valid, trim_qual - np.take_along_axis(q, rev_ix, 1), NEG)
    s3 = np.cumsum(d3, axis=1)
    cut3 = np.where(s3.max(axis=1) > 0, s3.argmax(axis=1) + 1, 0)
    lo = cut5
    new_len = lens - cut3 - lo
    rows = np.nonzero(new_len >= min_len)[0]
    if len(rows) == 0:
        return ReadBatch.from_seqs([])
    nl = new_len[rows]
    lmax = int(nl.max())
    src = np.clip(lo[rows][:, None] + np.arange(lmax)[None, :], 0, L - 1)
    in_read = np.arange(lmax)[None, :] < nl[:, None]
    codes = np.where(in_read, np.take_along_axis(batch.codes[rows], src, 1), 4)
    quals = np.where(in_read, np.take_along_axis(batch.quals[rows], src, 1), -1)
    return ReadBatch(
        codes=codes.astype(np.int8),
        lengths=nl.astype(np.int32),
        names=[batch.names[i] for i in rows],
        quals=quals.astype(np.int8),
    )


def clean_reads(
    batch: ReadBatch,
    trim_qual: int = 3,
    min_len: int = 25,
    adapter_3p: Optional[str] = None,
    adapter_5p: Optional[str] = None,
    adapter_error_rate: float = 0.1,
) -> ReadBatch:
    """Quality- and adapter-trim reads, drop short ones (the cutadapt
    step, reference: target.clean_reads). Quality trimming uses cutadapt's
    partial-sum algorithm; adapters are removed 3' (suffix-anchored) and
    5' (prefix-anchored) before the quality pass, with cutadapt's -e
    error tolerance (default 0.1)."""
    if len(batch) == 0 or batch.quals is None:
        return batch
    if not (adapter_3p or adapter_5p):
        return _quality_trim_batch(batch, trim_qual, min_len)
    keep_seqs: List[str] = []
    keep_names: List[str] = []
    keep_quals: List[List[int]] = []
    for i in range(len(batch)):
        length = int(batch.lengths[i])
        if adapter_3p or adapter_5p:
            seq = batch.seq(i)
            lo5 = (
                _find_adapter_5p(seq, adapter_5p,
                                 error_rate=adapter_error_rate)
                if adapter_5p else 0
            )
            hi3 = (
                _find_adapter_3p(seq, adapter_3p,
                                 error_rate=adapter_error_rate)
                if adapter_3p else length
            )
            if hi3 < lo5:
                continue
            length = hi3
            a_lo = lo5
        else:
            a_lo = 0
        q = batch.quals[i, a_lo:length].astype(np.int32)
        # cutadapt algorithm: trim from 3' end where running sum of
        # (trim_qual - q) is maximal
        deltas = trim_qual - q[::-1]
        sums = np.cumsum(deltas)
        cut3 = 0
        if sums.size and sums.max() > 0:
            cut3 = int(np.argmax(sums)) + 1
        deltas5 = trim_qual - q
        sums5 = np.cumsum(deltas5)
        cut5 = 0
        if sums5.size and sums5.max() > 0:
            cut5 = int(np.argmax(sums5)) + 1
        lo, hi = a_lo + cut5, length - cut3
        if hi - lo < min_len:
            continue
        keep_seqs.append(batch.seq(i)[lo:hi])
        keep_names.append(batch.names[i])
        keep_quals.append([int(x) for x in batch.quals[i, lo:hi]])
    return ReadBatch.from_seqs(keep_seqs, names=keep_names, quals=keep_quals)
