"""Synthetic-panel fixture builder (SURVEY.md §4.1 golden-parity fixtures).

Constructs a small reference genome, a sample haplotype described as a
list of blocks, reads tiled over the haplotype, and a SAM file whose
alignments are what a simple aligner would emit: full matches inside
blocks, soft clips at junctions — exactly the shapes the extractor keys on
(reference: target.extract_bam_reads classes).

The planted SV is the expected call ("constructed truth"); goldens are not
diffs against a reference binary run, which is unavailable offline
(SURVEY.md provenance caveat). TODO: diff against real BreaKmer output if
the reference mount ever populates.
"""

from __future__ import annotations

import dataclasses
import random
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from breakmer_tpu_torch.encode import revcomp


def rand_seq(seed: int, n: int) -> str:
    rng = random.Random(seed)
    return "".join(rng.choice("ACGT") for _ in range(n))


@dataclasses.dataclass
class GenomeModel:
    """Repeat-rich genome generator (VERDICT r3 missing #1).

    Uniform-random ACGT is the easiest possible background for a
    k-mer-subtraction caller; real targeted panels are dominated by
    repeats. This model carves the four confounders UCSC rmsk tracks
    (reference: utils.py setup_rmask consumers [recon]) into a random
    background, at densities giving ~25-30% masked sequence:

    - a dispersed ~300 bp repeat family (Alu analog): one consensus per
      genome, planted at ``alu_per_kb`` loci per kb across ALL chroms,
      each copy with ``alu_divergence`` point divergence, random strand,
      and 30% chance of 5' truncation — multi-mapping seed pressure;
    - tandem repeats: unit 2-50 bp repeated to 60-300 bp, 2% impurity;
    - homopolymer runs of 8-30 bp;
    - low-complexity stretches: 50-200 bp over a 2-letter alphabet.

    ``realistic_genome`` returns the sequences plus the true feature
    intervals as a repeat-mask dict (written to BED for utils/rmask.py),
    so the sweeps exercise the rmask/complexity filter stack for real."""

    alu_len: int = 300
    alu_divergence: float = 0.08
    alu_per_kb: float = 0.5
    tandem_per_kb: float = 0.3
    tandem_unit: Tuple[int, int] = (2, 50)
    tandem_total: Tuple[int, int] = (60, 300)
    homopoly_per_kb: float = 0.4
    homopoly_len: Tuple[int, int] = (8, 30)
    lowcomp_per_kb: float = 0.12
    lowcomp_len: Tuple[int, int] = (50, 200)


def _mutate(seq: str, rate: float, rng: random.Random) -> str:
    return "".join(
        rng.choice([b for b in "ACGT" if b != c]) if rng.random() < rate else c
        for c in seq
    )


def realistic_genome(
    seed: int,
    lengths: Dict[str, int],
    model: Optional[GenomeModel] = None,
) -> Tuple[Dict[str, str], Dict[str, List[Tuple[int, int, str]]]]:
    """Generate a repeat-rich genome: (sequences, mask_intervals).

    mask_intervals are the TRUE planted feature spans (0-based half-open,
    non-overlapping), chrom -> [(start, end, kind)] with kind in
    {alu, tandem, homopoly, lowcomp} — the ground-truth rmsk BED."""
    model = model or GenomeModel()
    rng = random.Random(seed)
    alu = "".join(rng.choice("ACGT") for _ in range(model.alu_len))
    genome: Dict[str, str] = {}
    mask: Dict[str, List[Tuple[int, int, str]]] = {}
    for chrom, L in lengths.items():
        seq = list("".join(rng.choice("ACGT") for _ in range(L)))
        ivs: List[Tuple[int, int, str]] = []

        def free(s: int, e: int) -> bool:
            return s >= 0 and e <= L and all(
                e <= a or s >= b for a, b, _ in ivs
            )

        def plant(frag: str, kind: str) -> None:
            for _ in range(40):  # rejection-sample a non-overlapping slot
                s = rng.randrange(0, max(1, L - len(frag)))
                if free(s, s + len(frag)):
                    seq[s:s + len(frag)] = frag
                    ivs.append((s, s + len(frag), kind))
                    return

        kb = L / 1000.0

        def count(per_kb: float) -> int:
            x = per_kb * kb
            return int(x) + (1 if rng.random() < x - int(x) else 0)

        for _ in range(count(model.alu_per_kb)):
            copy = _mutate(alu, model.alu_divergence, rng)
            if rng.random() < 0.3:
                copy = copy[rng.randrange(0, model.alu_len * 2 // 3):]
            if rng.random() < 0.5:
                copy = revcomp(copy)
            plant(copy, "alu")
        for _ in range(count(model.tandem_per_kb)):
            u = rng.randint(*model.tandem_unit)
            unit = "".join(rng.choice("ACGT") for _ in range(u))
            total = rng.randint(*model.tandem_total)
            reps = unit * (total // u + 1)
            plant(_mutate(reps[:total], 0.02, rng), "tandem")
        for _ in range(count(model.homopoly_per_kb)):
            plant(rng.choice("ACGT") * rng.randint(*model.homopoly_len),
                  "homopoly")
        for _ in range(count(model.lowcomp_per_kb)):
            ab = rng.sample("ACGT", 2)
            n = rng.randint(*model.lowcomp_len)
            plant("".join(rng.choice(ab) for _ in range(n)), "lowcomp")
        genome[chrom] = "".join(seq)
        mask[chrom] = sorted(ivs)
    return genome, mask


def write_mask_bed(path: str | Path,
                   mask: Dict[str, List[Tuple[int, int, str]]]) -> None:
    with open(path, "w") as fh:
        for chrom in sorted(mask):
            for s, e, kind in mask[chrom]:
                fh.write(f"{chrom}\t{s}\t{e}\t{kind}\n")


def mask_distance(
    mask: Dict[str, List[Tuple[int, int, str]]], chrom: str, pos: int
) -> Tuple[Optional[int], Optional[str]]:
    """(distance to the nearest mask feature, its kind); 0 = inside."""
    ivs = mask.get(chrom)
    if not ivs:
        return None, None
    d, k = None, None
    for s, e, kind in ivs:
        cur = 0 if s <= pos < e else min(abs(pos - s), abs(pos - (e - 1)))
        if d is None or cur < d:
            d, k = cur, kind
    return d, k


@dataclasses.dataclass
class ErrorModel:
    """Illumina-like sequencing-error model (VERDICT r2 missing #1).

    Per-base substitution rate ramping from 0.5x the mean at the 5' end to
    2x at the 3' end (mean ``sub_rate``), occasional 1-2 bp indel errors,
    and quality strings correlated with the errors: baseline quality decays
    linearly ``q_start`` -> ``q_end`` across the read with +-2 jitter;
    substituted bases get a low quality (Q8-Q20) except a ``miscalibrated``
    fraction that keeps the baseline (undetectable miscalls)."""

    sub_rate: float = 0.008
    indel_rate: float = 0.0004
    q_start: int = 38
    q_end: int = 27
    miscalibrated: float = 0.15


_CIG_NUM = "0123456789"


def _expand_cigar(cigar: str) -> List[Tuple[int, str]]:
    out, n = [], 0
    for ch in cigar:
        if ch in _CIG_NUM:
            n = n * 10 + ord(ch) - 48
        else:
            out.append((n, ch))
            n = 0
    return out


def apply_errors(
    seq: str, cigar: str, rng: random.Random, em: ErrorModel
) -> Tuple[str, str, str]:
    """Corrupt one read with the error model; returns (seq, cigar, qual).

    CIGAR surgery keeps the alignment the one a real aligner would emit for
    the corrupted read: substitutions leave it unchanged, an inserted error
    base inside an M run becomes 1I (inside S/I it extends that op), a
    deleted read base inside an M run becomes 1D (leading/trailing D is
    folded into POS by the caller's convention of never deleting the first
    or last aligned base — such errors are skipped instead)."""
    L = len(seq)
    if L == 0 or seq == "*":
        return seq, cigar, "*"
    aligned = cigar not in ("*", "")
    # items: ["b", base_char, op] per read base, interleaved with
    # ["D", count] for reference-only ops; H/P dropped (fixtures never
    # emit them)
    items: List[list] = []
    if aligned:
        i = 0
        for n, op in _expand_cigar(cigar):
            if op in "MIS=X":
                for _ in range(n):
                    items.append(["b", seq[i], op])
                    i += 1
            elif op == "D":
                items.append(["D", n])
    else:
        items = [["b", c, "M"] for c in seq]

    # pass 1: substitutions + per-base quality (ramped rate, 0.5x -> 2x)
    quals: List[int] = []
    base_idx = 0
    out_items: List[list] = []
    n_bases = sum(1 for it in items if it[0] == "b")
    for it in items:
        if it[0] == "D":
            out_items.append(it)
            continue
        frac = base_idx / max(n_bases - 1, 1)
        q = em.q_start + (em.q_end - em.q_start) * frac + rng.randint(-2, 2)
        rate = em.sub_rate * (0.5 + 1.5 * frac)
        if rng.random() < rate:
            it = ["b", rng.choice([b for b in "ACGT" if b != it[1]]), it[2]]
            if rng.random() >= em.miscalibrated:
                q = rng.randint(8, 20)
        out_items.append(it + [int(max(2, min(41, q)))])
        base_idx += 1
    # pass 2: indel errors (1-2 bp), never touching the first/last read base
    items = out_items
    final: List[list] = []
    for pos, it in enumerate(items):
        if it[0] == "D" or pos == 0 or pos == len(items) - 1:
            final.append(it)
            continue
        if rng.random() < em.indel_rate:
            width = rng.randint(1, 2)
            if rng.random() < 0.5:
                # inserted error bases (low qual); op I inside M, else same
                op = "I" if it[2] == "M" else it[2]
                final.append(it)
                for _ in range(width):
                    final.append(["b", rng.choice("ACGT"), op,
                                  rng.randint(8, 20)])
            else:
                # deleted read base: M -> 1D marker, S/I -> just dropped
                if it[2] == "M":
                    final.append(["D", 1])
                # (width>1 deletions collapse to 1 here to keep the
                # never-delete-the-last-base guard simple)
        else:
            final.append(it)

    new_seq = "".join(it[1] for it in final if it[0] == "b")
    qual = "".join(chr(33 + it[3]) for it in final if it[0] == "b")
    if not aligned:
        return new_seq, cigar, qual
    # recompress ops -> cigar (merge adjacent runs; adjacent D's sum)
    runs: List[list] = []
    for it in final:
        op = "D" if it[0] == "D" else it[2]
        n = it[1] if it[0] == "D" else 1
        if runs and runs[-1][1] == op:
            runs[-1][0] += n
        else:
            runs.append([n, op])
    new_cigar = "".join(f"{n}{op}" for n, op in runs)
    return new_seq, new_cigar, qual


@dataclasses.dataclass
class Polymorphism:
    """Benign germline polymorphism model (VERDICT r3 missing #2).

    Real samples differ from the reference by ~1 het SNP / kb and
    frequent 1-6 bp het indels even without any SV; each SNP mints ~k
    sample-only k-mers — the classic FP pressure on k-mer subtraction.
    Variants are generated once per sample (GermlineVariants) and applied
    at read level: every read is assigned a haplotype and carries exactly
    the variants on it, so het variants appear in ~half the reads."""

    snp_rate: float = 1 / 800.0
    indel_rate: float = 1 / 8000.0
    indel_max: int = 6
    hom_frac: float = 0.33


class GermlineVariants:
    """A sample's germline variant track over the reference genome.

    variants: chrom -> sorted [(pos, ref_len, alt, on_a, on_b)]; ref_len 0
    = insertion of ``alt`` before pos; alt '' = deletion of
    seq[pos:pos+ref_len]; SNP = (pos, 1, base). Applied to individual
    reads via cigar surgery (``apply``): SNPs swap the base (alignment
    unchanged), indels splice I/D ops into M runs — what a real aligner
    would emit for a germline carrier read."""

    def __init__(self, genome: Dict[str, str], seed: int,
                 model: Optional[Polymorphism] = None):
        model = model or Polymorphism()
        self.model = model
        rng = random.Random(seed)
        rate = model.snp_rate + model.indel_rate
        self.by_chrom: Dict[str, List[Tuple[int, int, str, bool, bool]]] = {}
        for chrom in sorted(genome):
            seq = genome[chrom]
            out: List[Tuple[int, int, str, bool, bool]] = []
            p = 1 + int(rng.expovariate(rate))
            while p < len(seq) - model.indel_max - 2:
                if rng.random() < model.hom_frac:
                    on_a = on_b = True
                else:
                    on_a = rng.random() < 0.5
                    on_b = not on_a
                if rng.random() < model.indel_rate / rate:
                    k = rng.randint(1, model.indel_max)
                    if rng.random() < 0.5:
                        ins = "".join(rng.choice("ACGT") for _ in range(k))
                        out.append((p, 0, ins, on_a, on_b))
                    else:
                        out.append((p, k, "", on_a, on_b))
                else:
                    alt = rng.choice([b for b in "ACGT" if b != seq[p]])
                    out.append((p, 1, alt, on_a, on_b))
                # keep variants >= 8 bp apart so indel surgeries never
                # overlap
                p += 8 + int(rng.expovariate(rate))
            self.by_chrom[chrom] = out

    def apply(self, rname: str, pos0: int, cigar: str, seq: str,
              hap: int) -> Tuple[str, str]:
        """Apply this read's haplotype variants; returns (seq, cigar).
        Soft-clipped spans are left untouched (their reference placement
        is elsewhere); the first/last read base is never edited so the
        cigar stays well-formed (no leading/trailing I/D)."""
        if cigar in ("*", "") or rname not in self.by_chrom or not seq:
            return seq, cigar
        span = sum(n for n, op in _expand_cigar(cigar) if op in "MD=X")
        hits = [v for v in self.by_chrom[rname]
                if (v[3] if hap == 0 else v[4])
                and pos0 <= v[0] < pos0 + span]
        if not hits:
            return seq, cigar
        # items: ["b", base, op, refpos|None] per read base; ["D", n]
        items: List[list] = []
        i, rp = 0, pos0
        for n, op in _expand_cigar(cigar):
            if op in "M=X":
                for _ in range(n):
                    items.append(["b", seq[i], "M", rp])
                    i += 1
                    rp += 1
            elif op in "IS":
                for _ in range(n):
                    items.append(["b", seq[i], op, None])
                    i += 1
            elif op == "D":
                items.append(["D", n])
                rp += n
        last = len(items) - 1
        for pos, ref_len, alt, _a, _b in hits:
            idx = [j for j, it in enumerate(items)
                   if it[0] == "b" and it[2] == "M" and it[3] is not None
                   and pos <= it[3] < pos + max(ref_len, 1)]
            if ref_len == 1 and alt:  # SNP
                if idx:
                    items[idx[0]][1] = alt
            elif ref_len == 0:  # insertion before pos
                at = next((j for j, it in enumerate(items)
                           if it[0] == "b" and it[3] == pos), None)
                if at is None or at == 0 or at >= last:
                    continue
                items[at:at] = [["b", c, "I", None] for c in alt]
                last = len(items) - 1
            else:  # deletion of [pos, pos+ref_len)
                idx = [j for j in idx if 0 < j < last]
                if not idx:
                    continue
                items[idx[0]:idx[-1] + 1] = [["D", len(idx)]]
                last = len(items) - 1
        new_seq = "".join(it[1] for it in items if it[0] == "b")
        runs: List[list] = []
        for it in items:
            op = "D" if it[0] == "D" else it[2]
            n = it[1] if it[0] == "D" else 1
            if runs and runs[-1][1] == op:
                runs[-1][0] += n
            else:
                runs.append([n, op])
        new_cigar = "".join(f"{n}{op}" for n, op in runs)
        return new_seq, new_cigar


@dataclasses.dataclass
class RefBlock:
    chrom: str
    start: int
    end: int
    strand: str = "+"


@dataclasses.dataclass
class NovelBlock:
    seq: str


Block = Union[RefBlock, NovelBlock]


class Haplotype:
    """A sample haplotype = concatenation of blocks over a reference."""

    def __init__(self, genome: Dict[str, str], blocks: Sequence[Block]):
        self.genome = genome
        self.blocks = list(blocks)
        parts = []
        for b in self.blocks:
            if isinstance(b, NovelBlock):
                parts.append(b.seq)
            else:
                seg = genome[b.chrom][b.start : b.end]
                parts.append(seg if b.strand == "+" else revcomp(seg))
        self.seq = "".join(parts)
        # sample-coordinate offsets of each block
        self.offsets = []
        off = 0
        for b, p in zip(self.blocks, parts):
            self.offsets.append(off)
            off += len(p)

    def map_prefix(self, s: int) -> Tuple[Optional[RefBlock], int, int]:
        """For sample position s: (block, pos_in_block, remaining_in_block).
        Returns block=None for novel blocks."""
        for b, off in zip(self.blocks, self.offsets):
            ln = (len(b.seq) if isinstance(b, NovelBlock) else b.end - b.start)
            if off <= s < off + ln:
                if isinstance(b, NovelBlock):
                    return None, s - off, off + ln - s
                return b, s - off, off + ln - s
        return None, 0, 0


def sam_record_for_read(
    hap: Haplotype, s: int, length: int, name: str
) -> Tuple[str, int, int, str, str]:
    """(rname, flag, pos0, cigar, seq) — how a real aligner would place
    a read starting at sample coordinate ``s``: anchor on the forward
    reference block with the LONGEST overlap (BWA-MEM picks the
    highest-scoring = longest contiguous match as primary, NOT the
    leftmost-in-read — r4: first-block anchoring put every
    chr2-leading reciprocal-trl junction read on the off-target
    chromosome, which a real panel run would not do), soft-clipping
    everything outside that block."""
    seq = hap.seq[s : s + length]
    best = None  # (matched, read_offset, block, in_block)
    pos = s
    while pos < s + length:
        b2, ib2, rem2 = hap.map_prefix(pos)
        if rem2 == 0:
            break
        matched = min(s + length - pos, rem2)
        if b2 is not None and b2.strand == "+":
            # strictly-greater keeps the old first-block choice on ties
            if best is None or matched > best[0]:
                best = (matched, pos - s, b2, ib2)
        pos += rem2
    if best is None:
        return "*", 4, -1, "*", seq  # unmapped (fully novel/inverted)
    matched, clip, block, in_block = best
    tail = length - clip - matched
    cigar = (f"{clip}S" if clip else "") + f"{matched}M" + (
        f"{tail}S" if tail else ""
    )
    return block.chrom, 0, block.start + in_block, cigar, seq


class SamBuilder:
    def __init__(
        self,
        genome: Dict[str, str],
        error_model: Optional[ErrorModel] = None,
        error_seed: int = 0,
        germline: Optional[GermlineVariants] = None,
    ):
        self.genome = genome
        self.lines: List[str] = []
        self._n = 0
        self.error_model = error_model
        self._err_rng = random.Random(error_seed)
        # benign germline polymorphism: each read gets a haplotype and
        # carries that haplotype's variants (het SNPs in ~half the reads)
        self.germline = germline
        self._hap_rng = random.Random(error_seed + 77)

    def _add(self, qname, flag, rname, pos0, mapq, cigar, rnext, pnext0, tlen, seq):
        if self.germline is not None and seq != "*":
            seq, cigar = self.germline.apply(
                rname, pos0, cigar, seq, self._hap_rng.randint(0, 1)
            )
        if self.error_model is not None and seq != "*":
            seq, cigar, qual = apply_errors(
                seq, cigar, self._err_rng, self.error_model
            )
        else:
            qual = "I" * len(seq) if seq != "*" else "*"
        self.lines.append(
            "\t".join(
                [
                    qname, str(flag), rname, str(pos0 + 1), str(mapq), cigar,
                    rnext, str(pnext0 + 1), str(tlen), seq, qual,
                ]
            )
        )

    def add_haplotype_reads(
        self, hap: Haplotype, start: int, end: int, read_len: int = 100,
        step: float = 7, prefix: str = "hap",
    ) -> None:
        """Tile single-end reads over hap.seq[start:end]. ``step`` may be
        fractional (<1 gives depth beyond 1x per base via duplicate start
        positions — PCR-duplicate-like, used by the VAF/depth sweeps)."""
        pos_f, lim = float(start), min(end, len(hap.seq)) - read_len + 1
        while pos_f < lim:
            # round() can land on the exclusive limit (reads must satisfy
            # s + read_len <= len(hap.seq), like the old range() did)
            s = min(int(round(pos_f)), lim - 1)
            pos_f += step
            self._n += 1
            rname, flag, pos, cigar, seq = sam_record_for_read(
                hap, s, read_len, f"{prefix}{self._n}"
            )
            self._add(f"{prefix}{self._n}", flag, rname, max(pos, 0), 60, cigar,
                      "*", -1, 0, seq)

    def add_background_pairs(
        self, chrom: str, start: int, end: int, read_len: int = 100, step: int = 25,
        insert: int = 300, prefix: str = "bg",
    ) -> None:
        """Proper pairs straight from the reference (coverage, no SV)."""
        ref = self.genome[chrom]
        for s in range(start, end - insert - read_len, step):
            self._n += 1
            name = f"{prefix}{self._n}"
            r1 = ref[s : s + read_len]
            r2 = revcomp(ref[s + insert : s + insert + read_len])
            self._add(name, 99, chrom, s, 60, f"{read_len}M", "=",
                      s + insert, insert + read_len, r1)
            self._add(name, 147, chrom, s + insert, 60, f"{read_len}M", "=",
                      s, -(insert + read_len), ref[s + insert : s + insert + read_len])

    def add_discordant_pairs(
        self, chrom1: str, pos1: int, chrom2: str, pos2: int, n: int = 4,
        read_len: int = 100, prefix: str = "disc",
    ) -> None:
        """Pairs whose mates straddle two loci (translocation support)."""
        ref1, ref2 = self.genome[chrom1], self.genome[chrom2]
        for i in range(n):
            self._n += 1
            name = f"{prefix}{self._n}"
            s1 = pos1 - read_len - 20 - i * 15
            s2 = pos2 + 20 + i * 15
            self._add(name, 97, chrom1, s1, 60, f"{read_len}M", chrom2, s2, 0,
                      ref1[s1 : s1 + read_len])
            self._add(name, 145, chrom2, s2, 60, f"{read_len}M", chrom1, s1, 0,
                      ref2[s2 : s2 + read_len])

    def write(self, path: str | Path) -> None:
        with open(path, "w") as fh:
            for chrom, seq in self.genome.items():
                fh.write(f"@SQ\tSN:{chrom}\tLN:{len(seq)}\n")
            fh.write("\n".join(self.lines) + "\n")
