"""Seed k-mer indexes for realignment candidate generation.

Replaces BLAT's tile index and the resident gfServer whole-genome index
(reference: sv_caller.py blat/gfclient runners + runner.start_blat_server,
SURVEY.md §2 #11): a sorted-array k-mer -> positions index, one per target
region (SeedIndex) and one genome-wide (GenomeIndex, chrom-concatenated
with an offset table). Lookups are vectorized numpy binary searches; there
is no socket hop and no subprocess. The genome index is built once and
replicated per host (SURVEY.md §2b "index sharding"; chromosome-sharded
variant is the parallel/ package's concern). It persists as a directory of
``.npy`` arrays that ``GenomeIndex.load`` maps read-only, so every process
on a node shares one copy in the OS page cache and reads only the pages
its queries touch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import uuid
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from breakmer_tpu_torch.encode import encode_seq, revcomp_codes


def _seed_codes(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(codes, positions) of all valid k-mers in a base-code array (host,
    vectorized rolling evaluation)."""
    codes = np.asarray(codes)
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    # one windowed dot product instead of a k-step shift-accumulate loop
    # (bad-window values are filtered out below, so masking before the
    # accumulate is unnecessary); the loop's per-step numpy dispatches
    # dominated at region-sized inputs
    win = np.lib.stride_tricks.sliding_window_view(codes, k)
    bad = (win >= 4).any(axis=1)
    weights = np.left_shift(np.int64(1), 2 * np.arange(k - 1, -1, -1, dtype=np.int64))
    acc = win.astype(np.int64) @ weights
    pos = np.nonzero(~bad)[0]
    return acc[pos], pos


@dataclasses.dataclass
class Window:
    """A candidate target window for SW scoring."""

    t_start: int
    t_end: int
    strand: str          # '+': query as-is; '-': revcomp(query) vs window
    nseeds: int
    chrom: Optional[str] = None   # set by GenomeIndex candidates


class SeedIndex:
    """Sorted k-mer index over one target sequence.

    ``step`` indexes every step-th position only — BLAT's gfServer tiles
    the genome with non-overlapping k-mers (stepSize == tileSize), which
    divides genome index memory by k while queries (which scan every
    query k-mer) still hit every tile (SURVEY.md §2a gfServer row).
    ``max_hits_per_seed`` drops pathologically repetitive seeds, the
    analog of BLAT's repMatch/maxHits guard.
    """

    def __init__(self, codes: np.ndarray, k: int, step: int = 1,
                 max_hits_per_seed: int = 64):
        self.k = k
        self.step = step
        self.max_hits_per_seed = max_hits_per_seed
        self.length = len(codes)
        seed_codes, positions = _seed_codes(codes, k)
        if step > 1:
            keep = positions % step == 0
            seed_codes, positions = seed_codes[keep], positions[keep]
        order = np.argsort(seed_codes, kind="stable")
        seed_codes = seed_codes[order]
        positions = positions[order]
        if max_hits_per_seed > 0 and len(seed_codes):
            # rank of each entry within its (sorted) code run; cap the run
            starts = np.r_[True, seed_codes[1:] != seed_codes[:-1]]
            run_ids = np.cumsum(starts) - 1
            run_first_idx = np.nonzero(starts)[0]
            rank = np.arange(len(seed_codes)) - run_first_idx[run_ids]
            keep = rank < max_hits_per_seed
            seed_codes, positions = seed_codes[keep], positions[keep]
        self._codes = seed_codes
        self._pos = positions

    def lookup(self, code: int) -> np.ndarray:
        lo = np.searchsorted(self._codes, code, side="left")
        hi = np.searchsorted(self._codes, code, side="right")
        return self._pos[lo:hi]

    def hits(self, query_codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """All (query_pos, target_pos) seed hits for a query sequence."""
        q_codes, q_pos = _seed_codes(query_codes, self.k)
        lo = np.searchsorted(self._codes, q_codes, side="left")
        hi = np.searchsorted(self._codes, q_codes, side="right")
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
        qp = np.repeat(q_pos, counts)
        # flatten ranges [lo_i, hi_i) into one index vector WITHOUT a
        # per-k-mer Python loop (the old arange-per-range comprehension
        # ran ~150k iterations per warm 400-gene panel pass and was the
        # single largest host cost of the realign stage): each output
        # slot j in range i holds lo_i + (j - ragged_start_i)
        ragged_starts = np.cumsum(counts) - counts
        idx = (
            np.arange(total, dtype=np.int64)
            - np.repeat(ragged_starts, counts)
            + np.repeat(lo, counts)
        )
        return qp, self._pos[idx]

    def candidates(
        self,
        query_codes: np.ndarray,
        band: int = 48,
        pad: int = 96,
        max_windows: int = 8,
        min_seeds: int = 2,
    ) -> List[Window]:
        """Diagonal-cluster seed hits into candidate windows, both strands.

        Hits are grouped by diagonal (t_pos - q_pos) bands; each cluster
        becomes a window [min_diag - pad, max_diag + len(query) + pad]
        clipped to the target. Windows are ranked by seed count. This is
        the blat-equivalent seed stage (SURVEY.md §7 layer 4).
        """
        L = len(query_codes)
        hits_by_strand = [
            ("+", *self.hits(query_codes)),
            ("-", *self.hits(revcomp_codes(query_codes))),
        ]
        return cluster_candidates(
            hits_by_strand, self.length, L, band, pad, max_windows, min_seeds
        )


def cluster_candidates(
    hits_by_strand,
    target_length: int,
    L: int,
    band: int = 48,
    pad: int = 96,
    max_windows: int = 8,
    min_seeds: int = 2,
) -> List[Window]:
    """Shared clustering core (SeedIndex AND the mesh-sharded index use
    this exact code path, so their candidate windows are identical by
    construction). ``hits_by_strand``: [(strand, q_pos[], t_pos[])] with
    hits ordered (q_pos asc, then table run order)."""
    out: List[Window] = []
    for strand, qp, tp in hits_by_strand:
        if len(qp) == 0:
            continue
        diag = np.asarray(tp) - np.asarray(qp)
        order = np.argsort(diag, kind="stable")
        diag = diag[order]
        # cluster: split where diagonal jumps by more than `band`; groups
        # below min_seeds (the overwhelming majority at genome scale —
        # random background hits are diagonal singletons) are dropped
        # VECTORIZED before any per-group Python runs (the old np.split
        # + per-group loop was ~45 ms/query vs ~0.5 ms now; windows are
        # identical — same groups, same ascending-diagonal order)
        splits = np.nonzero(np.diff(diag) > band)[0] + 1
        # np.concatenate, not np.r_: np.r_'s index-trick dispatch measured
        # ~0.35 ms/query of pure overhead at genome scale (8 chroms x 2
        # strands x 2 calls)
        zero = np.zeros(1, dtype=splits.dtype)
        end = np.full(1, len(diag), dtype=splits.dtype)
        starts = np.concatenate([zero, splits])
        ends = np.concatenate([splits, end])
        sizes = ends - starts
        keep = np.nonzero(sizes >= min_seeds)[0]
        for g in keep:
            d_lo = int(diag[starts[g]])
            d_hi = int(diag[ends[g] - 1])
            t_start = max(0, d_lo - pad)
            t_end = min(target_length, d_hi + L + pad)
            if t_end <= t_start:
                continue
            out.append(Window(t_start, t_end, strand, int(sizes[g])))
    out.sort(key=lambda w: (-w.nseeds, w.t_start, w.strand))
    # merge overlapping same-strand windows (keep the larger seed count)
    merged: List[Window] = []
    for w in out:
        absorbed = False
        for m in merged:
            if m.strand == w.strand and not (
                w.t_end <= m.t_start or w.t_start >= m.t_end
            ):
                m.t_start = min(m.t_start, w.t_start)
                m.t_end = max(m.t_end, w.t_end)
                m.nseeds += w.nseeds
                absorbed = True
                break
        if not absorbed:
            merged.append(w)
    return merged[:max_windows]


class PackedChrom:
    """2-bit packed chromosome + N-run intervals — the resident sequence
    store of the gfServer/2bit replacement (SURVEY.md §2a). ~0.28 B/base
    (vs 1 B/base unpacked int8); N runs (assembly gaps dominate real
    genomes) are [start, end) interval arrays, not a per-base mask.
    ``fetch`` decodes any window back to int8 base codes with Ns restored.
    """

    __slots__ = ("packed", "length", "n_starts", "n_ends")

    def __init__(self, packed: np.ndarray, length: int,
                 n_starts: np.ndarray, n_ends: np.ndarray):
        self.packed = packed
        self.length = length
        self.n_starts = n_starts
        self.n_ends = n_ends

    @classmethod
    def from_codes(cls, codes: np.ndarray) -> "PackedChrom":
        from breakmer_tpu_torch.encode import pack_2bit

        codes = np.asarray(codes, dtype=np.int8)
        m = codes >= 4
        if m.any():
            d = np.diff(m.astype(np.int8))
            starts = np.nonzero(d == 1)[0] + 1
            ends = np.nonzero(d == -1)[0] + 1
            if m[0]:
                starts = np.r_[0, starts]
            if m[-1]:
                ends = np.r_[ends, len(codes)]
        else:
            starts = ends = np.empty(0, dtype=np.int64)
        return cls(pack_2bit(codes), len(codes),
                   starts.astype(np.int64), ends.astype(np.int64))

    def fetch(self, start: int, end: int) -> np.ndarray:
        from breakmer_tpu_torch.encode import unpack_2bit

        start = max(0, int(start))
        end = min(self.length, int(end))
        if end <= start:
            return np.empty(0, dtype=np.int8)
        w0 = start // 16
        w1 = (end + 15) // 16
        codes = unpack_2bit(self.packed[w0:w1], (w1 - w0) * 16)
        codes = codes[start - w0 * 16 : end - w0 * 16]
        i0 = int(np.searchsorted(self.n_ends, start, side="right"))
        i1 = int(np.searchsorted(self.n_starts, end, side="left"))
        for s, e in zip(self.n_starts[i0:i1], self.n_ends[i0:i1]):
            codes[max(int(s) - start, 0) : int(e) - start] = 4
        return codes

    @property
    def nbytes(self) -> int:
        return (self.packed.nbytes + self.n_starts.nbytes + self.n_ends.nbytes)


def _iter_chunk_seeds(fetch, length: int, k: int, step: int,
                      chunk: int = 1 << 23):
    """Yield (codes uint32, start positions int64) of N-free k-mer seeds
    at positions ≡ 0 (mod step), streaming in fixed chunks: the build
    transient is O(chunk), never O(chrom) (the r1 design's whole-chrom
    int64 rolling pass would transiently allocate ~8 B/base — ~25 GB at
    human scale; VERDICT r1 missing #2)."""
    n = length - k + 1
    for c0 in range(0, max(n, 0), chunk):
        c1 = min(c0 + chunk, n)
        if step > 1:
            first = ((c0 + step - 1) // step) * step
            starts = np.arange(first, c1, step, dtype=np.int64)
        else:
            starts = np.arange(c0, c1, dtype=np.int64)
        if not len(starts):
            continue
        seg = np.asarray(fetch(c0, min(c1 - 1 + k, length)), dtype=np.int8)
        rel = starts - c0
        acc = np.zeros(len(starts), dtype=np.uint32)
        bad = np.zeros(len(starts), dtype=bool)
        for j in range(k):
            w = seg[rel + j]
            b = w >= 4
            bad |= b
            acc = (acc << np.uint32(2)) | np.where(b, 0, w).astype(np.uint32)
        ok = ~bad
        yield acc[ok], starts[ok]


# Direct bucket table limit: offsets are (4^k + 1) int64 — 128 MiB at
# k=12. Region SeedIndexes (sorted arrays) go to k=15; the genome-wide
# index matches BLAT's DNA tile range (gfServer tileSize <= 12 without
# over-occupied tables).
MAX_GENOME_K = 12

# The persisted form (``GenomeIndex.save``): a directory that holds one
# ``.npy`` an array and this file, written last.
INDEX_FORMAT = 3
_META = "meta.json"


def _offsets_of(counts: np.ndarray) -> np.ndarray:
    """The bucket table's offsets (int64, one more than ``counts``)."""
    offsets = np.empty(len(counts) + 1, dtype=np.int64)
    offsets[0] = 0
    np.cumsum(counts, out=offsets[1:])
    return offsets


def is_saved(path) -> bool:
    """Whether ``path`` holds a whole index that ``GenomeIndex.save`` wrote
    (a save moves its directory into place only once it is complete)."""
    return (Path(path) / _META).is_file()


class GenomeIndex:
    """Whole-genome seed index over a 2-bit-resident genome — the
    in-memory replacement for gfServer+2bit (reference:
    runner.start_blat_server; SURVEY.md §2a), genome-scale by design:

      * sequences live as PackedChrom (2-bit + N intervals, ~0.28 B/base);
        ``fetch_codes`` decodes windows on demand;
      * the seed table is DIRECT-ADDRESSED (counting sort): one global
        ``offsets[4^k + 1]`` bucket table plus one flat ``positions``
        array in concatenated genome coordinates (uint32 when the genome
        fits 4 Gbp — the human genome does). No per-seed code array at
        all: the bucket index IS the code, which is what lets the index
        hold a 3 Gbp genome in ~1.2 GB at step=k (gfServer's resident
        footprint class) instead of the r1 design's ~7 GB;
      * the build streams chunk-wise per chromosome (two passes over the
        packed data: capped bucket counts, then counting-sort fill), so
        peak transient memory is one chromosome's int8 codes + O(chunk);
      * ``max_hits_per_seed`` caps each bucket PER CHROMOSOME at build
        (keeping the lowest positions), bit-identical to the per-chrom
        SeedIndex capping the r1 design used — candidate windows are
        unchanged (cross-tested).

    ``chrom_seqs`` is a dict {name: sequence str | int8 codes} or an
    iterable of (name, sequence) pairs — pass a generator to keep only
    one chromosome's unpacked sequence alive during the build.
    """

    def __init__(self, chrom_seqs, k: int = 11,
                 step: Optional[int] = None, max_hits_per_seed: int = 64):
        if k > MAX_GENOME_K:
            raise ValueError(
                f"GenomeIndex k={k} exceeds the direct-address limit "
                f"{MAX_GENOME_K} (4^k bucket table); region SeedIndex "
                f"supports k up to 15"
            )
        self.k = k
        self.max_hits_per_seed = max_hits_per_seed
        items = chrom_seqs.items() if hasattr(chrom_seqs, "items") else chrom_seqs
        self._chrom_names: List[str] = []
        self._packed: Dict[str, PackedChrom] = {}
        lengths: List[int] = []
        for name, seq in items:
            codes = seq if isinstance(seq, np.ndarray) else encode_seq(seq)
            self._chrom_names.append(name)
            self._packed[name] = PackedChrom.from_codes(codes)
            lengths.append(len(codes))
            del codes
        total = int(sum(lengths))
        # auto: dense index for panel-scale genomes, gfServer-style
        # non-overlapping tiles for real genomes (memory / k)
        self.step = step if step is not None else (1 if total < 50_000_000 else k)
        self._chrom_off = np.concatenate(
            [[0], np.cumsum(np.asarray(lengths, dtype=np.int64))]
        )
        self._build_table(total)

    def _build_table(self, total: int) -> None:
        """Two streaming passes (capped bucket counts, counting-sort fill),
        THREADED ACROSS CHROMOSOMES (r3, VERDICT r2 next #5): numpy
        releases the GIL in bincount/argsort/gather/scatter, so a small
        thread pool scales the build on multi-core hosts. Output is
        byte-identical to the serial build: per-chrom counts are exact,
        summation order over chroms is pinned, and pass-2 threads write
        disjoint slots (each chrom's slots are pre-reserved via its
        predecessors' capped counts — the rolling ``base`` below), so
        thread timing cannot reorder anything."""
        import os
        from concurrent.futures import ThreadPoolExecutor

        nb = 1 << (2 * self.k)
        cap = self.max_hits_per_seed if self.max_hits_per_seed > 0 else (1 << 62)
        names = self._chrom_names
        nthreads = max(1, min(len(names), os.cpu_count() or 1))
        cdtype = np.uint16 if cap <= 0xFFFF else np.int64

        # pass 1: per-chrom capped bucket counts (one bincount per chrom
        # over its concatenated chunk codes — 16x less bucket-array
        # traffic than per-chunk bincounts at the default chunk width)
        def chrom_counts(name: str) -> np.ndarray:
            pc = self._packed[name]
            parts = [
                cc for cc, _ in
                _iter_chunk_seeds(pc.fetch, pc.length, self.k, self.step)
            ]
            if not parts:
                return np.zeros(nb, dtype=cdtype)
            codes = parts[0] if len(parts) == 1 else np.concatenate(parts)
            raw = np.bincount(codes, minlength=nb)
            np.minimum(raw, cap, out=raw)
            return raw.astype(cdtype)

        with ThreadPoolExecutor(nthreads) as ex:
            per_chrom = list(ex.map(chrom_counts, names))
        counts = np.zeros(nb, dtype=np.int64)
        for c in per_chrom:
            counts += c
        self._offsets = _offsets_of(counts)
        del counts
        n_seeds = int(self._offsets[-1])
        pos_dtype = np.uint32 if total <= 0xFFFFFFFF else np.int64
        self._positions = np.empty(n_seeds, dtype=pos_dtype)

        # pass 2: counting-sort fill; chrom ci writes at
        # base_ci = offsets + sum of earlier chroms' capped counts —
        # disjoint slots per chrom, so chroms fill concurrently
        def fill_chrom(ci: int, base: np.ndarray) -> None:
            name = names[ci]
            pc = self._packed[name]
            goff = int(self._chrom_off[ci])
            fc = np.zeros(nb, dtype=np.int64)
            fw = np.zeros(nb, dtype=np.int64)
            for ccodes, cpos in _iter_chunk_seeds(
                pc.fetch, pc.length, self.k, self.step
            ):
                order = np.argsort(ccodes, kind="stable")
                sc = ccodes[order].astype(np.int64)
                sp = cpos[order]
                run_start = np.r_[True, sc[1:] != sc[:-1]]
                first = np.nonzero(run_start)[0]
                rank = np.arange(len(sc)) - first[np.cumsum(run_start) - 1]
                # within-chunk runs are position-ascending (stable sort of
                # an ascending-position chunk), so the per-chrom cap keeps
                # the lowest positions — same rule as SeedIndex
                keep = fc[sc] + rank < cap
                dest = base[sc] + fw[sc] + rank
                self._positions[dest[keep]] = sp[keep] + goff
                rc = sc[first]
                rlen = np.diff(np.r_[first, len(sc)])
                fw[rc] += np.minimum(rlen, np.maximum(0, cap - fc[rc]))
                fc[rc] += rlen

        # rolling write bases, dispatched in waves of nthreads so at most
        # nthreads+1 nb-sized int64 copies are alive at once
        run = self._offsets[:-1].copy()
        ci = 0
        with ThreadPoolExecutor(nthreads) as ex:
            while ci < len(names):
                wave = []
                for _ in range(nthreads):
                    if ci >= len(names):
                        break
                    last = ci == len(names) - 1
                    base = run if last else run.copy()
                    wave.append(ex.submit(fill_chrom, ci, base))
                    if not last:
                        run = run + per_chrom[ci]
                    per_chrom[ci] = None  # free as we go
                    ci += 1
                for f in wave:
                    f.result()

    # -- queries -----------------------------------------------------------

    def _hits_global(self, q_codes: np.ndarray, q_pos: np.ndarray):
        """(q_pos, global position) hit pairs, q-major then ascending
        global position within each seed (== per-chrom ascending)."""
        if not len(q_codes):
            e = np.empty(0, dtype=np.int64)
            return e, e
        qc = np.asarray(q_codes, dtype=np.int64)
        lo = self._offsets[qc]
        cnt = self._offsets[qc + 1] - lo
        tot = int(cnt.sum())
        if tot == 0:
            e = np.empty(0, dtype=np.int64)
            return e, e
        qp = np.repeat(q_pos, cnt)
        csum = np.cumsum(cnt)
        idx = np.arange(tot) - np.repeat(csum - cnt, cnt) + np.repeat(lo, cnt)
        return qp, self._positions[idx].astype(np.int64)

    def lookup_chrom(self, chrom: str, code: int) -> np.ndarray:
        """Local positions of one seed code in one chromosome (ascending;
        the per-chrom SeedIndex.lookup analog)."""
        ci = self._chrom_names.index(chrom)
        g0, g1 = int(self._chrom_off[ci]), int(self._chrom_off[ci + 1])
        lo, hi = int(self._offsets[code]), int(self._offsets[code + 1])
        seg = self._positions[lo:hi].astype(np.int64)
        a = int(np.searchsorted(seg, g0, side="left"))
        b = int(np.searchsorted(seg, g1, side="left"))
        return seg[a:b] - g0

    def candidates(self, query_codes: np.ndarray, **kw) -> List[Window]:
        L = len(query_codes)
        strands = []
        for strand, qcodes in (("+", np.asarray(query_codes, np.int8)),
                               ("-", revcomp_codes(query_codes))):
            qc, qpos = _seed_codes(qcodes, self.k)
            qp, gp = self._hits_global(qc, qpos)
            # one stable partition by chromosome instead of a per-chrom
            # boolean mask over the full hit array (was n_chroms x 2
            # full-array scans per query); stable argsort preserves the
            # q-major hit order within each chrom, so cluster_candidates
            # sees byte-identical inputs
            ci_of = np.searchsorted(self._chrom_off, gp, side="right") - 1
            order = np.argsort(ci_of, kind="stable")
            qp, gp, ci_of = qp[order], gp[order], ci_of[order]
            bounds = np.searchsorted(ci_of, np.arange(len(self._chrom_names) + 1))
            strands.append((strand, qp, gp, bounds))
        out: List[Window] = []
        for ci, chrom in enumerate(self._chrom_names):
            g0, g1 = int(self._chrom_off[ci]), int(self._chrom_off[ci + 1])
            hbs = []
            for strand, qp, gp, bounds in strands:
                a, b = int(bounds[ci]), int(bounds[ci + 1])
                hbs.append((strand, qp[a:b], gp[a:b] - g0))
            if all(len(h[1]) == 0 for h in hbs):
                continue
            for w in cluster_candidates(hbs, g1 - g0, L, **kw):
                w.chrom = chrom
                out.append(w)
        out.sort(key=lambda w: (-w.nseeds, w.chrom, w.t_start, w.strand))
        max_windows = kw.get("max_windows", 8)
        return out[:max_windows]

    # -- surface -----------------------------------------------------------

    @property
    def chroms(self) -> List[str]:
        return list(self._chrom_names)

    def fetch_codes(self, chrom: str, start: int, end: int) -> np.ndarray:
        return self._packed[chrom].fetch(start, end)

    def length(self, chrom: str) -> int:
        return self._packed[chrom].length

    @property
    def nbytes(self) -> int:
        """Resident bytes: packed genome + N intervals + bucket table +
        positions (the RAM-budget number ARCHITECTURE.md reports)."""
        return (
            sum(pc.nbytes for pc in self._packed.values())
            + self._offsets.nbytes + self._positions.nbytes
            + self._chrom_off.nbytes
        )

    def per_chrom_seed_arrays(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """{chrom: (codes int64, local positions int64)}, sorted by code
        with ascending position within each run — the legacy per-chrom
        table layout, materialized on demand for the sharded deployment
        (parallel.index_shard). Transiently O(n_seeds × 16 B); intended
        at panel scale — a sharded REAL genome would shard the direct
        table itself."""
        nb = 1 << (2 * self.k)
        codes_all = np.repeat(np.arange(nb, dtype=np.int64),
                              np.diff(self._offsets))
        gp = self._positions.astype(np.int64)
        out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for ci, chrom in enumerate(self._chrom_names):
            g0, g1 = int(self._chrom_off[ci]), int(self._chrom_off[ci + 1])
            sel = (gp >= g0) & (gp < g1)
            out[chrom] = (codes_all[sel], gp[sel] - g0)
        return out

    # -- persistence -------------------------------------------------------

    def save(self, path) -> None:
        """Write the index as the directory ``path``: one ``.npy`` an array
        (``offsets`` as the queries use it, int64, so that a load maps it
        and computes nothing) and ``meta.json``. The directory is written
        as a ``<path>.partial-*`` sibling and moved into place whole, so a
        reader never takes half an index. Where another writer put a whole
        index at ``path`` first (two processes on one cache), that one is
        kept and this one dropped."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        # a name of its own for each writer, with the umask's mode (a cache
        # that several users' processes read; mkdtemp would make it 0700)
        stage = path.with_name(f"{path.name}.partial-{uuid.uuid4().hex}")
        stage.mkdir()
        try:
            arrays = {"positions": self._positions}
            # panel-scale genomes leave most of the 4^k buckets empty:
            # there the nonzero counts are kept, and a load rebuilds the
            # offsets (a cumsum over 4^k, far below a panel index's build)
            counts = np.diff(self._offsets)
            nz = np.nonzero(counts)[0]
            sparse = 2 * len(nz) < len(counts)
            if sparse:
                arrays["bucket_nz"] = nz.astype(np.uint32)
                arrays["bucket_nz_counts"] = counts[nz].astype(np.uint32)
            else:
                arrays["offsets"] = self._offsets
            # every chromosome's packed words and N runs end to end, so a
            # load maps five files whatever the assembly's count of contigs
            # (each map is a few system calls, ~1.5 ms on a 9p file system)
            pcs = [self._packed[c] for c in self._chrom_names]
            for name, attr in (("packed", "packed"), ("nstarts", "n_starts"), ("nends", "n_ends")):
                arrays[name] = np.concatenate([getattr(pc, attr) for pc in pcs])
            for name, a in arrays.items():
                np.save(stage / f"{name}.npy", np.ascontiguousarray(a))
            meta = {"format": INDEX_FORMAT, "k": self.k, "step": self.step,
                    "cap": self.max_hits_per_seed, "sparse": sparse,
                    # [name, bases, packed words, N runs]
                    "chroms": [[c, pc.length, len(pc.packed), len(pc.n_starts)]
                               for c, pc in zip(self._chrom_names, pcs)]}
            (stage / _META).write_text(json.dumps(meta))
            try:
                os.replace(stage, path)
            except OSError:
                if not is_saved(path):
                    raise
        finally:
            shutil.rmtree(stage, ignore_errors=True)

    @classmethod
    def load(cls, path) -> "GenomeIndex":
        """The index that ``save`` wrote to the directory ``path``, every
        array mapped read-only: nothing is read whole, copied or touched
        before a query needs it. A ``.npz`` of the v2 format that earlier
        versions wrote is read whole."""
        if Path(path).is_dir():
            return cls._map(Path(path))
        return cls._read_npz(path)

    @classmethod
    def _map(cls, path: Path) -> "GenomeIndex":
        meta = json.loads((path / _META).read_text())
        if meta.get("format") != INDEX_FORMAT:
            raise ValueError(f"{path} holds genome index format {meta.get('format')}, "
                             f"not {INDEX_FORMAT}; delete it to rebuild")

        def arr(name: str) -> np.ndarray:
            # a str, not a Path: np.memmap resolves a Path, an lstat a
            # component of it
            return np.load(str(path / f"{name}.npy"), mmap_mode="r")

        self = cls.__new__(cls)
        self.k, self.step, self.max_hits_per_seed = meta["k"], meta["step"], meta["cap"]
        chroms = meta["chroms"]
        self._chrom_names = [c[0] for c in chroms]
        self._chrom_off = np.concatenate(
            [[0], np.cumsum(np.asarray([c[1] for c in chroms], dtype=np.int64))])
        self._positions = arr("positions")
        if meta["sparse"]:
            counts = np.zeros(1 << (2 * self.k), dtype=np.int64)
            counts[arr("bucket_nz")] = arr("bucket_nz_counts")
            self._offsets = _offsets_of(counts)
        else:
            self._offsets = arr("offsets")
        packed, nstarts, nends = arr("packed"), arr("nstarts"), arr("nends")
        self._packed = {}
        w = r = 0
        for c, n, words, runs in chroms:
            self._packed[c] = PackedChrom(packed[w:w + words], n,
                                          nstarts[r:r + runs], nends[r:r + runs])
            w, r = w + words, r + runs
        return self

    @classmethod
    def _read_npz(cls, path) -> "GenomeIndex":
        with np.load(path) as data:
            if "__v2__" not in data.files:
                raise ValueError(
                    f"{path} is a pre-v2 genome index artifact; rebuild it "
                    "(delete the cache file) — the v2 packed format replaced it"
                )
            self = cls.__new__(cls)
            self.k = int(data["__k__"][0])
            self.step = int(data["__step__"][0])
            self.max_hits_per_seed = int(data["__cap__"][0])
            self._chrom_names = [str(n) for n in data["__names__"]]
            self._chrom_off = data["__chrom_off__"]
            if "__bucket_nz__" in data.files:
                counts = np.zeros(int(data["__nb__"][0]), dtype=np.int64)
                counts[data["__bucket_nz__"].astype(np.int64)] = data["__bucket_nz_counts__"]
            else:
                counts = data["__bucket_counts__"].astype(np.int64)
            self._offsets = _offsets_of(counts)
            self._positions = data["__positions__"]
            self._packed = {}
            for c in self._chrom_names:
                self._packed[c] = PackedChrom(
                    data[f"{c}::packed"], int(data[f"{c}::len"][0]),
                    data[f"{c}::nstarts"], data[f"{c}::nends"],
                )
        return self
