"""Mesh-sharded genome seed index — the distributed gfServer analog.

Port of ``breakmer_tpu/parallel/index_shard.py``. The sorted (code,
position, chrom) seed table is RANGE-SHARDED along the code axis over a
1-D mesh (``make_shard_mesh``): D contiguous shards of int64 columns,
each on its own device. A query batch (one contig's k-mers, both
strands) is copied to every shard, every shard answers with a local
binary search (``torch.searchsorted``, then take, clip and mask as the
JAX ``_lookup_local`` does), the [D, Q, H] hits and [D, Q] counts are
gathered on the mesh's first device, compacted there to the valid hits
in ``np.nonzero``'s (d, q, h) order, and fetched in one copy.

Parity: candidate windows are identical to GenomeIndex.candidates by
construction — the table is built FROM the per-chromosome seed arrays
(same max-hits capping), device hits are re-ordered to the host lookup's
(q_pos asc, t_pos asc) order, and clustering goes through
align.index.cluster_candidates, the code path the replicated index uses.
Tested for equality on a virtual CPU mesh against this module's JAX
original and GenomeIndex.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from breakmer_tpu_torch.align.index import GenomeIndex, Window, _seed_codes, cluster_candidates
from breakmer_tpu_torch.encode import revcomp_codes
from breakmer_tpu_torch.parallel.mesh import (
    Mesh, device_array, gather, mesh_devices, on_device, split_evenly,
)

AXIS_SHARDS = "shards"
SENT_CODE = np.int64(1 << 62)  # sorts after every real 2k-bit seed code


def make_shard_mesh(n_devices: Optional[int] = None,
                    devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """1-D mesh on "shards"; ``devices`` defaults to every visible card
    and may name a device more than once (a virtual mesh)."""
    devices = mesh_devices(n_devices, devices)
    return Mesh(device_array(devices, (len(devices),)), (AXIS_SHARDS,))


def _lookup_local(codes_l, pos_l, chrom_l, queries, h_pad: int):
    """One shard's lookup: binary-search the local code range, emit up to
    h_pad (position, chrom) hits per query plus the true local count
    (overflow detection)."""
    n_l = codes_l.shape[0]
    lo = torch.searchsorted(codes_l, queries, side="left")
    hi = torch.searchsorted(codes_l, queries, side="right")
    take = lo[:, None] + torch.arange(h_pad, dtype=lo.dtype, device=lo.device)[None, :]
    valid = take < hi[:, None]
    takec = take.clamp(0, n_l - 1)
    hpos = torch.where(valid, pos_l[takec], -1)
    hchrom = torch.where(valid, chrom_l[takec], -1)
    counts = (hi - lo).to(torch.int32)
    return hpos, hchrom, counts


class ShardedGenomeIndex:
    """Device-sharded wrapper over a built GenomeIndex.

    ``candidates`` has the same contract as GenomeIndex.candidates (and
    returns identical windows); ``fetch_codes`` delegates to the host
    genome copy (window sequences are fetched per winner — the 2-bit
    genome stays on the host while the far larger seed table is the
    sharded part).
    """

    def __init__(self, genome: GenomeIndex, mesh: Optional[Mesh] = None,
                 h_pad: Optional[int] = None):
        self._genome = genome
        self.k = genome.k
        self.mesh = mesh if mesh is not None else make_shard_mesh()
        self._chrom_names: List[str] = list(genome.chroms)
        parts_c, parts_p, parts_id = [], [], []
        per_chrom = genome.per_chrom_seed_arrays()
        for cid, chrom in enumerate(self._chrom_names):
            ccodes, cpos = per_chrom[chrom]
            parts_c.append(ccodes.astype(np.int64))
            parts_p.append(cpos.astype(np.int64))
            parts_id.append(np.full(len(ccodes), cid, dtype=np.int64))
        del per_chrom
        codes = np.concatenate(parts_c) if parts_c else np.empty(0, np.int64)
        pos = np.concatenate(parts_p) if parts_p else np.empty(0, np.int64)
        cid = np.concatenate(parts_id) if parts_id else np.empty(0, np.int64)
        # global sort by code; stable keeps (chrom, position) order within
        # a code run, matching the per-chrom hit order after the host-side
        # (q_pos, t_pos) re-sort
        order = np.argsort(codes, kind="stable")
        codes, pos, cid = codes[order], pos[order], cid[order]
        if h_pad is None:
            # exact per-shard capacity: the longest global code run (a
            # seed capped at 64/chrom can still hit 64*n_chroms in ONE
            # shard after the range sharding)
            if len(codes):
                starts = np.r_[0, np.nonzero(codes[1:] != codes[:-1])[0] + 1]
                h_pad = int(np.diff(np.r_[starts, len(codes)]).max())
            else:
                h_pad = 1
        self.h_pad = max(1, h_pad)
        D = self.mesh.devices.size
        n_pad = max(D, ((len(codes) + D - 1) // D) * D)
        padn = n_pad - len(codes)
        if padn:
            codes = np.concatenate([codes, np.full(padn, SENT_CODE)])
            pos = np.concatenate([pos, np.full(padn, -1, np.int64)])
            cid = np.concatenate([cid, np.full(padn, -1, np.int64)])
        # D contiguous shards of (code, position, chrom), each on its device
        self.shards: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
        for d, s in zip(self.mesh.devices.flat, split_evenly(n_pad, D, "seed table")):
            self.shards.append(tuple(torch.from_numpy(np.ascontiguousarray(a[s])).to(d)
                                     for a in (codes, pos, cid)))

    @property
    def shard_nbytes(self) -> int:
        """Bytes of one shard's table on its device."""
        return sum(x.numel() * x.element_size() for x in self.shards[0])

    def lookup(self, query_codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All (q_index, chrom_id, t_pos) seed hits for a query-code
        vector: a lookup on every shard, one gather and one fetch. Raises
        on per-shard overflow (a query k-mer with more than h_pad hits
        inside one shard)."""
        q = np.asarray(query_codes, dtype=np.int64)
        if len(q) == 0:
            return (np.empty(0, np.int64),) * 3
        host_q = torch.from_numpy(q)
        local = []
        for d, (codes_l, pos_l, chrom_l) in zip(self.mesh.devices.flat, self.shards):
            with on_device(d):
                local.append(_lookup_local(codes_l, pos_l, chrom_l, host_q.to(d), self.h_pad))
        first = self.mesh.first
        hpos, hchrom, counts = (gather([x[n][None] for x in local], first) for n in range(3))
        # [D, Q, H] hits, [D, Q] counts; keep the valid hits in (d, q, h)
        # order (np.nonzero's) so the one fetch carries hits only
        valid = hpos >= 0
        qi = torch.arange(len(q), device=first)[None, :, None].expand_as(hpos)[valid]
        flat = torch.cat([counts.max().to(torch.int64).reshape(1), qi,
                          hchrom[valid], hpos[valid]]).cpu().numpy()
        if flat[0] > self.h_pad:
            raise OverflowError(
                f"seed run exceeds h_pad={self.h_pad} in one shard; "
                "raise h_pad (per-chrom max_hits_per_seed bounds total hits)"
            )
        n = (len(flat) - 1) // 3
        return flat[1:1 + n], flat[1 + n:1 + 2 * n], flat[1 + 2 * n:]

    def candidates(self, query_codes: np.ndarray, **kw) -> List[Window]:
        max_windows = kw.get("max_windows", 8)
        L = len(query_codes)
        per_chrom_hits: Dict[str, list] = {c: [] for c in self._chrom_names}
        # ONE device round-trip for both strands: concatenate the strand
        # query vectors and split the hits by query index afterwards
        fw_codes, fw_pos = _seed_codes(np.asarray(query_codes, np.int8), self.k)
        rc_codes, rc_pos = _seed_codes(revcomp_codes(query_codes), self.k)
        qi, cid, tp = self.lookup(np.concatenate([fw_codes, rc_codes]))
        n_fw = len(fw_codes)
        for strand, sel_s, q_pos, off in (
            ("+", qi < n_fw, fw_pos, 0),
            ("-", qi >= n_fw, rc_pos, n_fw),
        ):
            qp_all = q_pos[qi[sel_s] - off] if sel_s.any() else qi[:0]
            cid_s, tp_s = cid[sel_s], tp[sel_s]
            for c_i, chrom in enumerate(self._chrom_names):
                sel = cid_s == c_i
                if not sel.any():
                    per_chrom_hits[chrom].append((strand, tp_s[:0], tp_s[:0]))
                    continue
                cqp, ctp = qp_all[sel], tp_s[sel]
                # host lookup order: q_pos asc, then position asc in run
                o = np.lexsort((ctp, cqp))
                per_chrom_hits[chrom].append((strand, cqp[o], ctp[o]))
        out: List[Window] = []
        for chrom in self._chrom_names:
            wins = cluster_candidates(
                per_chrom_hits[chrom], self._genome.length(chrom), L, **kw
            )
            for w in wins:
                w.chrom = chrom
                out.append(w)
        out.sort(key=lambda w: (-w.nseeds, w.chrom, w.t_start, w.strand))
        return out[:max_windows]

    # -- host-side delegates (same surface as GenomeIndex) ------------------
    @property
    def chroms(self) -> List[str]:
        return self._chrom_names

    def fetch_codes(self, chrom: str, start: int, end: int) -> np.ndarray:
        return self._genome.fetch_codes(chrom, start, end)

    def length(self, chrom: str) -> int:
        return self._genome.length(chrom)
