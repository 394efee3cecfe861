"""Batched multi-region k-mer step (BASELINE.json config #3).

Port of ``breakmer_tpu/parallel/kmer_batch.py``. The serial runner
pays one device round trip per region; this step packs G regions into
one fixed-shape batch (``parallel/regions.py``) and runs the k-mer
extract/count/subtract of all G in one call of each k-mer function
(``parallel/step._per_region_kmers``, shared with the region step),
optionally sharded over the regions axis of a mesh
(``parallel/mesh.py``): each regions block goes to its own device,
``_per_region_kmers`` runs per block, and the [G, K] outputs are
gathered on the mesh's first device before ``_compact_outputs`` runs
once over them (compaction after the ``all_gather``, as in JAX).

Against the JAX module:
  - Every entry point takes an explicit ``device``, or a ``mesh``.
  - There is no jit: the full and packed steps are plain functions.
  - Values are int64 on the device (SENTINEL sorts last, as in
    ``ops/kmer.py``), and so is the packed ``gid<<24 | count`` word; the
    host gets the JAX dtypes (values and words ``np.uint32``, counts
    ``np.int32``).
  - torch's scatter has no ``mode="drop"``: ``_compact_outputs`` sends
    every entry it drops to a spare slot past the buffer and cuts it off.
  - Inputs go to a card straight from the batch's own host arrays, which
    stay alive until the fetch anyway; a pinned copy would hold every
    pending batch a second time, in torch's pinned pool, which rounds
    each buffer up to a power of two, so that the process's peak memory
    jumps with the sample's read counts. The kernels still run while the
    host packs the next batch; one device-to-host copy fetches every
    pending packed output.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from breakmer_tpu_torch.utils.meter import METER
from breakmer_tpu_torch.ops.kmer import _SENT
from breakmer_tpu_torch.parallel.mesh import gather, on_device, split_evenly
from breakmer_tpu_torch.parallel.regions import RegionBatch, pack_region_batches, tier_key
from breakmer_tpu_torch.parallel.step import _per_region_kmers

_SENTINEL = np.uint32(0xFFFFFFFF)


# packed-fetch budget: valid sample-only kmers per region are typically
# tens (post min_count subtraction), so 512 slots/region is generous; a
# kmer-richer batch overflows the buffer, which the step reports (n=-1)
# and the host retries with the full-shape fetch — bit-exact either way
_PACK_SLOTS_PER_REGION = 512


def _compact_outputs(values: torch.Tensor, counts: torch.Tensor, cap: int):
    """Device-side compaction of the [G, K] kmer outputs (mostly sentinel
    padding) into (vals [cap], gc [cap] = gid<<24|count, n), int64 on the
    device. n=-1 signals overflow (n > cap, or a count >= 2^24 that would
    spill into the gid field): the caller refetches full shapes. Pure
    gather/scatter: bit-exact against the full fetch."""
    G, K = values.shape
    if G > 256:
        raise ValueError("gid field is 8 bits; split batches above 256 regions")
    flat_v = values.reshape(-1)
    flat_c = counts.reshape(-1).to(torch.int64)
    valid = (flat_v != _SENT) & (flat_c > 0)
    pos = torch.cumsum(valid, 0) - 1
    dest = torch.where(valid & (pos < cap), pos, cap)  # cap: the dropped slot
    out_v = flat_v.new_zeros(cap + 1).scatter_(0, dest, flat_v)[:cap]
    gid = (torch.arange(G * K, device=values.device) // K) << 24
    out_gc = flat_v.new_zeros(cap + 1).scatter_(0, dest, gid | flat_c)[:cap]
    n = valid.sum()
    bad = (n > cap) | (flat_c >= (1 << 24)).any()
    return out_v, out_gc, torch.where(bad, -1, n)


def _kmer_body(k: int, min_count: int, mesh=None) -> Callable:
    """Full-shape step: [G, ...] inputs -> (values [G, K] int64, counts
    [G, K] int32). Overflow refetch of the packed step; also the identity
    oracle in tests. With a mesh it takes one tuple of inputs a regions
    block, each on its block's device (``_upload_sharded``), and returns
    the gathered outputs on the mesh's first device."""
    body = functools.partial(_per_region_kmers, k=k, min_count=min_count)
    if mesh is None:
        return body

    def sharded(*blocks):
        outs = []
        for args in blocks:
            with on_device(args[0].device):
                outs.append(body(*args))
        return tuple(gather([o[n] for o in outs], mesh.first) for n in range(2))

    return sharded


def _kmer_step_packed(k: int, min_count: int, cap: int, mesh=None) -> Callable:
    """Packed step: same compute, compacted outputs for the cheap fetch."""
    body = _kmer_body(k, min_count, mesh)

    def fn(*a):
        return _compact_outputs(*body(*a), cap)

    return fn


def _step_args(b: RegionBatch) -> tuple:
    base = (b.reads, b.lengths, b.refs, b.ref_lengths)
    if b.normal_reads is not None:
        base += (b.normal_reads, b.normal_lengths)
    return base


def _upload(arrays, device: torch.device) -> tuple:
    """Host arrays -> tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def _upload_sharded(arrays, mesh) -> tuple:
    """Host arrays -> one tuple of tensors a regions block, each on the
    first device of its mesh row. G must split evenly over the regions
    axis."""
    rows = mesh.devices.shape[0]
    return tuple(_upload([a[gs] for a in arrays], mesh.devices[i, 0])
                 for i, gs in enumerate(split_evenly(arrays[0].shape[0], rows, "G (regions)")))


def _fetch_packed(outs) -> List[Tuple[np.ndarray, np.ndarray, int]]:
    """Every pending packed output in ONE device-to-host copy:
    [(vals, gc, n)] -> [(vals u32, gc u32, n int)]."""
    flat = torch.cat([x.reshape(-1) for out in outs for x in out]).cpu().numpy()
    fetched, at = [], 0
    for vals, _, _ in outs:
        cap = vals.shape[0]
        v = flat[at:at + cap].astype(np.uint32)
        gc = flat[at + cap:at + 2 * cap].astype(np.uint32)
        fetched.append((v, gc, int(flat[at + 2 * cap])))
        at += 2 * cap + 1
    return fetched


def _fetch_full(out) -> Tuple[np.ndarray, np.ndarray]:
    values, counts = out
    return values.cpu().numpy().astype(np.uint32), counts.cpu().numpy()


def _postprocess(batch: RegionBatch, values: np.ndarray, counts: np.ndarray):
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for g, name in enumerate(batch.names):
        if not name:
            continue
        v = values[g]
        c = counts[g]
        keep = (v != _SENTINEL) & (c > 0)
        v, c = v[keep], c[keep]
        order = np.lexsort((v, -c.astype(np.int64)))
        out[name] = (v[order], c[order])
    return out


def _postprocess_packed(batch: RegionBatch, vals: np.ndarray,
                        gcs: np.ndarray, n: int):
    """Packed-fetch twin of _postprocess: same valid-entry set, same
    per-region (count desc, code asc) order — identity-tested."""
    vals = vals[:n]
    gcs = gcs[:n]
    gid = gcs >> 24
    cnt = (gcs & np.uint32(0x00FFFFFF)).astype(np.int32)
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for g, name in enumerate(batch.names):
        if not name:
            continue
        m = gid == g
        v = vals[m]
        c = cnt[m]
        order = np.lexsort((v, -c.astype(np.int64)))
        out[name] = (v[order], c[order])
    return out


class KmerBatchPipeline:
    """Incremental batched k-mer stage: regions are added as host
    extraction finishes them; whenever a pad-tier group fills, its packed
    batch is launched at once (torch returns before a card finishes), so
    device k-mer compute overlaps the host's extraction of later regions,
    and ``results()`` yields per-batch outputs for host assembly.
    Region-level results are identical to run_kmer_batches (same pack,
    same step, same postprocess); only the launch schedule changes.

    ``dispatched`` and ``refetched`` count the packed launches and the
    overflow refetches of this pipeline. It runs on ``device``, or
    sharded over the regions axis of ``mesh`` (give one of the two); with
    a mesh, ``regions_per_batch`` must split evenly over that axis."""

    def __init__(self, k: int, min_count: int = 2, mesh=None,
                 regions_per_batch: int = 8, *, device=None):
        if (mesh is None) == (device is None):
            raise ValueError("KmerBatchPipeline: give exactly one of device and mesh")
        self.k = k
        self.min_count = min_count
        self.mesh = mesh
        self.rpb = regions_per_batch
        self.device = mesh.first if mesh is not None else torch.device(device)
        self._buffers: Dict[tuple, list] = {}
        self._pending: list = []
        self.dispatched = 0
        self.refetched = 0

    def add(self, name: str, batch, ref, normal=None) -> None:
        key = tier_key(batch, ref, normal, normal is not None)
        buf = self._buffers.setdefault(key, [])
        buf.append((name, batch, ref, normal))
        if len(buf) >= self.rpb:
            self._dispatch(list(buf))
            buf.clear()

    def _dispatch(self, members) -> None:
        with METER.stage("kmer_device"):
            (b,) = pack_region_batches(members, self.rpb)
            self._launch(b)

    def _launch(self, b: RegionBatch) -> None:
        cap = b.reads.shape[0] * _PACK_SLOTS_PER_REGION
        if self.mesh is None:
            args = _upload(_step_args(b), self.device)
        else:
            args = _upload_sharded(_step_args(b), self.mesh)
        out = _kmer_step_packed(self.k, self.min_count, cap, self.mesh)(*args)
        self._pending.append((b, out, args))
        self.dispatched += 1

    def results(self):
        """Flush partial groups, then yield {region: (values, counts)}
        per batch. ONE device-to-host copy for every pending packed
        output. A packed buffer that overflowed (n=-1) is recomputed with
        the full-shape step: rare, bit-exact."""
        for buf in self._buffers.values():
            if buf:
                self._dispatch(list(buf))
                buf.clear()
        pending, self._pending = self._pending, []
        if not pending:
            return
        with METER.stage("kmer_device"):
            fetched = _fetch_packed([out for _, out, _a in pending])
        for (b, _, args), (vals, gcs, n) in zip(pending, fetched):
            if n < 0:  # packed overflow: full-shape refetch
                with METER.stage("kmer_device"):
                    values, counts = _fetch_full(
                        _kmer_body(self.k, self.min_count, self.mesh)(*args))
                self.refetched += 1
                yield _postprocess(b, values, counts)
            else:
                yield _postprocess_packed(b, vals, gcs, n)

    def finish(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        merged: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for d in self.results():
            merged.update(d)
        return merged


def run_kmer_batch(
    batch: RegionBatch,
    k: int,
    min_count: int = 2,
    mesh=None,
    *,
    device=None,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """One device launch for G regions (on ``device``, or sharded over
    ``mesh``); returns per-region sample-only
    k-mers as {region_name: (values desc-by-count, counts)} — the same
    host-side contract as ops.kmer.sample_only_kmers, ready for the
    assembler. Batches built with a matched normal
    (RegionBatch.normal_reads) add the normal subtraction."""
    return run_kmer_batches([batch], k, min_count, mesh, device=device)


def run_kmer_batches(
    batches,
    k: int,
    min_count: int = 2,
    mesh=None,
    *,
    device=None,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Multi-batch form: launch EVERY batch before fetching anything,
    then one fetch for all outputs."""
    kb = KmerBatchPipeline(k, min_count, mesh, device=device)
    with METER.stage("kmer_device"):
        for b in batches:
            kb._launch(b)
    return kb.finish()
