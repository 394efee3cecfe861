"""Samples at a panel's published depth: read pairs over every target,
structural variants planted into some of them, and the truth they carry.

A frozen, vectorised copy of the port's scenario generator
(``testing/scenarios.py`` and ``testing/fixtures.py``): the same SV kinds
and size ranges, the same placement of a read by the aligner rule (the
longest forward reference block anchors it, the rest is soft-clipped, a
read of novel sequence only is unmapped), the same Illumina-like error
model, VAF dilution and a matched normal that carries the germline SVs.
Where it differs, it is the scale: read pairs from fragments of a set
insert size tile every target at the configuration's depth, reads keep
their sequenced length (an indel error shifts the reference span), and a
share of the background reads end in low-quality soft clips.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from svbench.gen.genome import Genome, Target

SV_KINDS = ("ins", "del", "dup", "inv", "trl")
M, I, D, S = 0, 1, 2, 4  # BAM CIGAR op codes
FLANK = 1000  # reference bases on each side of a junction in an SV haplotype


@dataclasses.dataclass
class Reads:
    """Read records as columns; ``cig_len``/``cig_op`` hold ``n_cig`` ops."""

    refid: np.ndarray
    pos: np.ndarray
    end: np.ndarray
    flag: np.ndarray
    mapq: np.ndarray
    next_refid: np.ndarray
    next_pos: np.ndarray
    tlen: np.ndarray
    n_cig: np.ndarray
    cig_len: np.ndarray
    cig_op: np.ndarray
    seq: np.ndarray
    qual: np.ndarray
    frag: np.ndarray

    def __len__(self) -> int:
        return len(self.pos)

    @classmethod
    def concat(cls, parts: List["Reads"]) -> "Reads":
        return cls(*(np.concatenate([getattr(p, f.name) for p in parts])
                     for f in dataclasses.fields(cls)))


@dataclasses.dataclass
class SV:
    """One planted SV and what its checker needs."""

    kind: str
    gene: str
    chrom: str
    mid: int
    size: int = 0
    tol: int = 4
    mid_norm: int = 0
    chrom2: str = ""
    p2: int = 0
    ins: Optional[np.ndarray] = None
    alt_local: Optional[np.ndarray] = None  # ref[mid-150:mid] + ins + ref[mid:mid+150]
    vaf: float = 1.0
    germline: bool = False

    @property
    def junctions(self) -> List[tuple]:
        if self.kind == "trl":
            return [(self.chrom, self.mid), (self.chrom2, self.p2)]
        if self.kind in ("del", "inv"):
            return [(self.chrom, self.mid), (self.chrom, self.mid + self.size)]
        if self.kind == "dup":
            return [(self.chrom, self.mid - self.size), (self.chrom, self.mid)]
        return [(self.chrom, self.mid)]


def _homology(left: np.ndarray, right: np.ndarray) -> int:
    """Common run at the two sequences' ends (scenarios._homology)."""
    n = min(len(left), len(right))
    if n == 0:
        return 0
    eq = left[len(left) - n:][::-1] == right[len(right) - n:][::-1]
    return int(n if eq.all() else np.argmin(eq))


def _rc(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1]


class _Hap:
    """An SV haplotype as blocks: ``("ref", chrom, start, end)`` (forward
    strand) or ``("novel", codes)``."""

    def __init__(self, genome: Genome, blocks: list):
        parts, self.ref_blocks = [], []  # (hap offset, length, chrom, ref start)
        off = 0
        for b in blocks:
            if b[0] == "novel":
                seq = b[1]
            else:
                seq = genome.fetch(b[1], b[2], b[3])
                self.ref_blocks.append((off, len(seq), b[1], b[2]))
            parts.append(seq)
            off += len(seq)
        self.seq = np.concatenate(parts).astype(np.uint8)


class SampleMaker:
    """Makes one sample (and its matched normal) of a configuration under
    a traffic mix, from one seed."""

    def __init__(self, genome: Genome, panel: List[Target], config: dict, mix: dict):
        self.genome = genome
        self.panel = panel
        self.cfg = config
        self.mix = mix
        self.refids = {n: i for i, n in enumerate(genome.names)}
        rd = config["reads"]
        self.L = int(rd["read_len"])
        self.ins_mean, self.ins_sd = float(rd["insert_mean"]), float(rd["insert_sd"])
        self.ins_lo, self.ins_hi = int(rd["insert_min"]), int(rd["insert_max"])
        self.flank = int(rd["capture_flank"])
        self.em = config["error_model"]

    # -- the SVs of a sample ----------------------------------------------
    def plan(self, rng: np.random.Generator) -> List[SV]:
        """Somatic SVs in ``sv_targets_frac`` of the targets, the kinds in
        equal shares and the VAFs spread evenly over the mix's range (both
        in an order drawn from the seed), and germline SVs in
        ``germline_targets_frac`` of them where the configuration has a
        normal. Every seed plants the same number of each kind."""
        n = len(self.panel)
        n_sv = max(1, int(round(float(self.mix["sv_targets_frac"]) * n)))
        kinds = [SV_KINDS[i % len(SV_KINDS)] for i in range(n_sv)]
        rng.shuffle(kinds)
        lo, hi = self.mix["vaf"]
        vafs = np.linspace(lo, hi, n_sv) if n_sv > 1 else np.array([hi])
        rng.shuffle(vafs)
        sv_targets = rng.permutation(n)[:n_sv]
        germ = set()
        if self.cfg.get("normal") is not None:
            n_g = int(round(float(self.mix["germline_targets_frac"]) * n))
            germ = set(int(t) for t in rng.permutation(n)[:n_g])
        svs = []
        somatic = dict(zip((int(t) for t in sv_targets), zip(kinds, vafs)))
        for ti, t in enumerate(self.panel):
            both = ti in somatic and ti in germ
            half = (t.start + t.end) // 2
            if ti in somatic:
                kind, vaf = somatic[ti]
                lo_m, hi_m = (t.start + 200, half - 200) if both else (t.start + 200, t.end - 200)
                svs.append(self._plant(rng, t, kind, float(vaf), lo_m, hi_m))
            if ti in germ:
                lo_m, hi_m = (half + 200, t.end - 200) if both else (t.start + 200, t.end - 200)
                sv = self._plant(rng, t, "ins", float(self.mix["germline_vaf"]), lo_m, hi_m)
                sv.germline = True
                svs.append(sv)
        return svs

    def _plant(self, rng, t: Target, kind: str, vaf: float, lo_m: int, hi_m: int) -> SV:
        g = self.genome
        mid = int(rng.integers(lo_m, max(lo_m + 1, hi_m)))
        ctx = lambda a, b: g.fetch(t.chrom, a, b)  # noqa: E731
        sv = SV(kind, t.name, t.chrom, mid, vaf=vaf)
        if kind == "ins":
            sv.size = int(rng.integers(16, 35))
            sv.ins = rng.integers(0, 4, sv.size).astype(np.uint8)
            h = _homology(ctx(mid - 100, mid), sv.ins) + _homology(sv.ins, ctx(mid, mid + 40)[::-1])
            sv.tol = 3 + h
            sv.alt_local = np.concatenate([ctx(mid - 150, mid), sv.ins, ctx(mid, mid + 150)])
        elif kind == "del":
            sv.size = int(rng.integers(35, 90))
            seq = ctx(mid - 400, mid + sv.size + 1)
            m = mid
            while m > mid - 399 and seq[m - 1 - (mid - 400)] == seq[m + sv.size - 1 - (mid - 400)]:
                m -= 1
            sv.mid_norm = m
        elif kind == "dup":
            sv.size = int(rng.integers(120, 220))
            sv.tol = 4 + _homology(ctx(mid - 100, mid), ctx(mid - sv.size - 100, mid - sv.size)) + _homology(
                ctx(mid - sv.size, mid)[::-1], ctx(mid, mid + 40)[::-1])
        elif kind == "inv":
            sv.size = size = int(rng.integers(120, 200))
            inv = _rc(ctx(mid, mid + size))
            lo = mid - 12
            base = np.concatenate([ctx(lo, mid), inv, ctx(mid + size, mid + size + 12)])
            amb = 0
            for s in range(-8, 9):
                m2 = mid + s
                cand = np.concatenate([ctx(lo, m2), _rc(ctx(m2, m2 + size)), ctx(m2 + size, mid + size + 12)])
                if len(cand) == len(base) and (cand == base).all():
                    amb = max(amb, abs(s))
            for k in range(1, 9):  # symmetric growth
                if (ctx(mid - k, mid) == _rc(ctx(mid + size, mid + size + k))).all():
                    amb = max(amb, k)
                else:
                    break
            for k in range(1, 9):  # symmetric shrink
                if (ctx(mid, mid + k) == _rc(ctx(mid + size - k, mid + size))).all():
                    amb = max(amb, k)
                else:
                    break
            sv.tol = 4 + amb
        elif kind == "trl":
            others = [c for c in g.names if c != t.chrom]
            sv.chrom2 = others[int(rng.integers(len(others)))]
            n2 = g.lengths[sv.chrom2]
            margin = min(2_000_000, n2 // 4)
            sv.p2 = int(rng.integers(margin, n2 - margin))
            g2 = lambda a, b: g.fetch(sv.chrom2, a, b)  # noqa: E731
            sv.tol = 3 + _homology(ctx(mid - 100, mid), g2(sv.p2 - 100, sv.p2)) + _homology(
                ctx(mid, mid + 40)[::-1], g2(sv.p2, sv.p2 + 40)[::-1])
        return sv

    def _hap(self, sv: SV) -> tuple:
        """(haplotype, first junction, last junction, affected reference
        interval) of an SV."""
        c, m, z = sv.chrom, sv.mid, sv.size
        if sv.kind == "ins":
            blocks = [("ref", c, m - FLANK, m), ("novel", sv.ins), ("ref", c, m, m + FLANK)]
            return _Hap(self.genome, blocks), FLANK, FLANK + z, (m, m)
        if sv.kind == "del":
            blocks = [("ref", c, m - FLANK, m), ("ref", c, m + z, m + z + FLANK)]
            return _Hap(self.genome, blocks), FLANK, FLANK, (m, m + z)
        if sv.kind == "dup":
            blocks = [("ref", c, m - FLANK, m), ("ref", c, m - z, m + FLANK)]
            return _Hap(self.genome, blocks), FLANK, FLANK, (m - z, m)
        if sv.kind == "inv":
            inv = _rc(self.genome.fetch(c, m, m + z))
            blocks = [("ref", c, m - FLANK, m), ("novel", inv), ("ref", c, m + z, m + z + FLANK)]
            return _Hap(self.genome, blocks), FLANK, FLANK + z, (m, m + z)
        blocks = [("ref", c, m - FLANK, m), ("ref", sv.chrom2, sv.p2, sv.p2 + FLANK)]
        return _Hap(self.genome, blocks), FLANK, FLANK, (m, m)

    # -- reads ------------------------------------------------------------
    def reads(self, seeds: List[int], svs: List[SV], depth: float, germline_only: bool,
              frag_base: int, threads: int = 4) -> Reads:
        """Every target's reads, each target from its own seed (so the
        threads that make them cannot change what they make)."""
        by_gene: Dict[str, List[SV]] = {}
        for sv in svs:
            if sv.germline or not germline_only:
                by_gene.setdefault(sv.gene, []).append(sv)

        def one(i: int) -> Reads:
            rng = np.random.Generator(np.random.PCG64(np.random.SeedSequence(seeds + [i])))
            return self._target_reads(rng, self.panel[i], by_gene.get(self.panel[i].name, []), depth)

        with ThreadPoolExecutor(threads) as pool:
            parts = list(pool.map(one, range(len(self.panel))))
        base = frag_base
        for part in parts:
            part.frag += base
            base += int(part.frag.max() - base) + 1 if len(part.frag) else 0
        return Reads.concat(parts)

    def _inserts(self, rng, n: int) -> np.ndarray:
        ins = np.rint(rng.normal(self.ins_mean, self.ins_sd, n)).astype(np.int64)
        return np.clip(ins, self.ins_lo, self.ins_hi)

    def _target_reads(self, rng, t: Target, svs: List[SV], depth: float) -> Reads:
        L = self.L
        s0, s1 = t.start - self.flank, t.end + self.flank
        n = int(round(depth * (s1 - s0) / (2 * L)))
        ins = self._inserts(rng, n)
        f = rng.integers(s0, s1 - ins)
        keep = np.ones(n, dtype=bool)
        alt_parts = []
        for sv in svs:
            hap, j0, j1, (a, b) = self._hap(sv)
            # fragments over the affected interval come from the SV
            # haplotype at the SV's VAF: drop that share of the reference
            # fragments and put as many fragments over its junctions
            over = keep & (f < b + 1) & (f + ins > a)
            drop = over & (rng.random(n) < sv.vaf)
            keep &= ~drop
            alt_parts.append((hap, j0, j1, int(drop.sum())))
        f, ins = f[keep], ins[keep]
        ref = self.genome.fetch(t.chrom, s0 - 2, s1 + 2)
        out = [self._ref_pairs(rng, t.chrom, ref, s0 - 2, f, ins, 0)]
        frag = len(f)
        for hap, j0, j1, k in alt_parts:
            if k:
                out.append(self._hap_pairs(rng, hap, j0, j1, k, frag))
                frag += k
        return Reads.concat(out)

    def _errors(self, rng, seq: np.ndarray, reverse: np.ndarray) -> np.ndarray:
        """Substitutions (rate ramping 0.5x -> 2x the mean from the 5' end)
        and qualities (q_start -> q_end, +-2; a substituted base gets
        Q8-Q20 unless miscalibrated). Edits ``seq`` in place; returns qual."""
        em = self.em
        n, L = seq.shape
        frac = np.linspace(0.0, 1.0, L, dtype=np.float32)
        rate = (em["sub_rate"] * (0.5 + 1.5 * frac)).astype(np.float32)
        sub = rng.random((n, L), dtype=np.float32) < np.where(reverse[:, None], rate[::-1], rate)
        k = int(sub.sum())
        seq[sub] = (seq[sub] + rng.integers(1, 4, k, dtype=np.uint8)) % 4
        base = np.rint(em["q_start"] + (em["q_end"] - em["q_start"]) * frac).astype(np.int16)
        q = np.where(reverse[:, None], base[::-1], base) + rng.integers(-2, 3, (n, L), dtype=np.int16)
        low = np.zeros_like(sub)
        low[sub] = rng.random(k) >= em["miscalibrated"]
        q[low] = rng.integers(8, 21, int(low.sum()), dtype=np.int16)
        return np.clip(q, 2, 41).astype(np.uint8)

    def _ref_pairs(self, rng, chrom, ref, ref0, f, ins, frag0) -> Reads:
        """Proper FR pairs of reference fragments: the left mate at the
        fragment start, the right mate reverse at its end. Indel errors
        (a 1-base insertion or deletion, the read keeping its length) and
        low-quality soft-clipped 3' ends on a share of the reads."""
        L, em = self.L, self.em
        n = len(f)
        pos = np.concatenate([f, f + ins - L])
        reverse = np.concatenate([np.zeros(n, bool), np.ones(n, bool)])
        m = 2 * n
        n_cig = np.ones(m, np.uint8)
        cig_len = np.zeros((m, 3), np.int32)
        cig_op = np.zeros((m, 3), np.uint8)
        cig_len[:, 0] = L
        span = np.full(m, L, np.int64)
        # low-quality soft-clipped 3' ends
        clip = rng.random(m) < self.mix["softclip_frac"]
        c = rng.integers(10, 41, m)
        # indel errors on the other reads: one base inserted or deleted at q
        p_read = 1.0 - (1.0 - em["indel_rate"]) ** (L - 2)
        indel = ~clip & (rng.random(m) < p_read)
        q = rng.integers(1, L - 1, m)
        is_ins = rng.random(m) < 0.5
        col = np.arange(L, dtype=np.int32)[None, :]
        ii = indel & is_ins
        dd = indel & ~is_ins
        span[ii] -= 1
        span[dd] += 1
        for sel, op in ((ii, I), (dd, D)):
            n_cig[sel] = 3
            cig_len[sel, 0] = q[sel]
            cig_len[sel, 1] = 1
            cig_op[sel, 1] = op
            cig_len[sel, 2] = L - q[sel] - (1 if op == I else 0)
        idx = (pos - ref0).astype(np.int32)[:, None] + col
        idx[ii] -= col >= q[ii, None]
        idx[dd] += col >= q[dd, None]
        seq = ref[idx]
        seq[ii, q[ii]] = rng.integers(0, 4, int(ii.sum()), dtype=np.uint8)
        qual = self._errors(rng, seq, reverse)
        # the clipped 3' end: random bases at Q5-Q15; a forward read clips
        # on its right, a reverse read on its left (its POS moves right)
        fw_c, rv_c = clip & ~reverse, clip & reverse
        n_cig[clip] = 2
        cig_len[fw_c, 0], cig_op[fw_c, 0] = L - c[fw_c], M
        cig_len[fw_c, 1], cig_op[fw_c, 1] = c[fw_c], S
        cig_len[rv_c, 0], cig_op[rv_c, 0] = c[rv_c], S
        cig_len[rv_c, 1], cig_op[rv_c, 1] = L - c[rv_c], M
        tail = (col >= L - c[:, None]) & fw_c[:, None] | (col < c[:, None]) & rv_c[:, None]
        seq[tail] = rng.integers(0, 4, int(tail.sum()), dtype=np.uint8)
        qual[tail] = rng.integers(5, 16, int(tail.sum()))
        pos = pos + np.where(rv_c, c, 0)
        span = np.where(clip, L - c, span)
        refid = np.full(m, self.refids[chrom], np.int32)
        mate = np.concatenate([np.arange(n, m), np.arange(n)])
        r1_left = rng.random(n) < 0.5
        first = np.concatenate([r1_left, ~r1_left])
        flag = (0x1 | 0x2 | np.where(reverse, 0x10, 0x20) | np.where(first, 0x40, 0x80)).astype(np.uint16)
        tl = (pos + span)[mate].clip(min=pos + span) - np.minimum(pos, pos[mate])
        tlen = np.where(reverse, -tl, tl).astype(np.int32)
        return Reads(refid, pos.astype(np.int32), (pos + span).astype(np.int32), flag,
                     np.full(m, 60, np.uint8), refid.copy(), pos[mate].astype(np.int32), tlen,
                     n_cig, cig_len, cig_op, seq.astype(np.uint8), qual,
                     np.concatenate([np.arange(frag0, frag0 + n)] * 2))

    def _hap_pairs(self, rng, hap: _Hap, j0: int, j1: int, k: int, frag0: int) -> Reads:
        """``k`` fragments of the SV haplotype over its junctions, each mate
        placed by the aligner rule."""
        L = self.L
        ins = self._inserts(rng, k)
        hi = np.minimum(j1, len(hap.seq) - ins)
        f = rng.integers(np.maximum(0, j0 - ins + 1), np.maximum(hi, j0 - ins + 2))
        r = np.concatenate([f, f + ins - L])
        reverse = np.concatenate([np.zeros(k, bool), np.ones(k, bool)])
        m = 2 * k
        # overlap of each read with each forward reference block; the
        # longest anchors it (the first on a tie)
        ov = np.stack([np.clip(np.minimum(r + L, o + ln) - np.maximum(r, o), 0, None)
                       for o, ln, _c, _s in hap.ref_blocks], axis=1)
        best = np.argmax(ov, axis=1)
        matched = ov[np.arange(m), best]
        mapped = matched > 0
        b_off = np.array([b[0] for b in hap.ref_blocks])[best]
        b_ref = np.array([b[3] for b in hap.ref_blocks])[best]
        b_chr = np.array([self.refids[b[2]] for b in hap.ref_blocks], np.int32)[best]
        m0 = np.maximum(r, b_off)
        lclip = m0 - r
        tail = L - lclip - matched
        pos = b_ref + (m0 - b_off)
        n_cig = np.zeros(m, np.uint8)
        cig_len = np.zeros((m, 3), np.int32)
        cig_op = np.zeros((m, 3), np.uint8)
        for i in np.nonzero(mapped)[0]:  # at most a few thousand reads a sample
            ops = ([(lclip[i], S)] if lclip[i] else []) + [(matched[i], M)] + ([(tail[i], S)] if tail[i] else [])
            n_cig[i] = len(ops)
            for j, (ln, op) in enumerate(ops):
                cig_len[i, j], cig_op[i, j] = ln, op
        seq = hap.seq[r[:, None] + np.arange(L)[None, :]].copy()
        qual = self._errors(rng, seq, reverse)
        mate = np.concatenate([np.arange(k, m), np.arange(k)])
        both = mapped & mapped[mate]
        keep = mapped | mapped[mate]
        # an unmapped mate takes its mate's place (SAM: RNAME and POS of the mate)
        refid = np.where(mapped, b_chr, b_chr[mate]).astype(np.int32)
        pos = np.where(mapped, pos, pos[mate])
        end = np.where(mapped, pos + matched, pos + 1)
        first = np.concatenate([np.ones(k, bool), np.zeros(k, bool)])
        same = both & (refid == refid[mate])
        lo = np.minimum(pos, pos[mate])
        tl = np.maximum(end, end[mate]) - lo
        fr = np.where(reverse, pos[mate] <= pos, pos <= pos[mate])
        proper = same & fr & (tl <= 1000)
        flag = (0x1 | np.where(proper, 0x2, 0) | np.where(~mapped, 0x4, 0) | np.where(~mapped[mate], 0x8, 0)
                | np.where(reverse, 0x10, 0x20) | np.where(first, 0x40, 0x80)).astype(np.uint16)
        tlen = np.where(same, np.where(pos == lo, tl, -tl), 0).astype(np.int32)
        frag = np.concatenate([np.arange(frag0, frag0 + k)] * 2)
        sel = np.nonzero(keep)[0]
        return Reads(refid[sel], pos[sel].astype(np.int32), end[sel].astype(np.int32), flag[sel],
                     np.where(mapped, 60, 0).astype(np.uint8)[sel], refid[mate][sel],
                     pos[mate][sel].astype(np.int32), tlen[sel], n_cig[sel], cig_len[sel],
                     cig_op[sel], seq[sel], qual[sel], frag[sel])


@dataclasses.dataclass
class Sample:
    name: str
    tumour: Reads
    normal: Optional[Reads]
    svs: List[SV]


def make_sample(maker: SampleMaker, seed: int, index: int) -> Sample:
    """Sample ``index`` of a run with ``seed``: its SVs, its tumour reads
    and, where the configuration has one, its matched normal. Under a mix
    whose ``sv_plan`` is "fixed" the SVs of sample ``index`` are the same
    for every seed (a validation cell line; the seed draws its reads);
    otherwise the seed draws them too."""
    fixed = maker.mix.get("sv_plan") == "fixed"
    plan_seed = [int(maker.cfg["panel"]["seed"]), 1 << 40] if fixed else [seed]
    svs = maker.plan(np.random.Generator(np.random.PCG64(np.random.SeedSequence(plan_seed + [index]))))
    depth = float(maker.cfg["reads"]["depth"])
    tumour = maker.reads([seed, index, 0], svs, depth, germline_only=False, frag_base=0)
    normal = None
    if maker.cfg.get("normal") is not None:
        normal = maker.reads([seed, index, 1], svs, float(maker.cfg["normal"]["depth"]),
                             germline_only=True, frag_base=len(tumour))
    return Sample(f"s{index}", tumour, normal, svs)
