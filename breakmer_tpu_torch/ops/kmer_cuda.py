"""Wrappers of the hand-written CUDA kernels of the k-mer engine
(``csrc/kmer.cu``): ``kmer_codes``, ``revcomp_kmers``,
``unique_counts_sorted`` and ``subtract_sorted`` of ``ops/kmer.py`` on
CUDA tensors, one launch a call, as XLA runs each of the jitted functions
of ``breakmer_tpu/ops/kmer.py`` as one program. ``both_strands`` is the
``revcomp_kmers`` kernel's both-strand form (a row's codes, then their
reverse complements: the JAX step's ``concatenate`` of the two, which XLA
fuses into one program) and counts as a launch of that kernel.

The kernel library is built and loaded on the first launch, never at
import, so this module imports on a machine without ``nvcc`` or a card.
Each wrapper checks device, dtype and shape and raises on anything its
kernel does not take (it never converts a dtype), makes its inputs
contiguous, allocates its outputs with ``torch.empty`` and launches on
PyTorch's current stream through ``_build.launch``, which raises on a
refused launch. A zero-size input gives empty outputs and launches
nothing: CUDA refuses a grid of 0 blocks. Codes are int64 and SENTINEL
is 0xFFFFFFFF, as in ``ops/kmer.py``; rows [N] or [G, N] are taken row by
row.

``region_kmers`` is a serial region's whole ``sample_only_kmers`` call in
one launch of one thread-block cluster (``csrc/region_kmers.cu``): host
numpy in, packed into one pinned buffer and copied to the card once, the
kept (value, count) pairs copied back once. ``region_plan`` says, from
the shapes and the card's limits alone and before anything touches the
card, whether a region's layout fits a CTA's opt-in shared memory at a
cluster size the card runs, and at which; ``ops/kmer.py`` routes by it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from breakmer_tpu_torch import _build

SENTINEL = 0xFFFFFFFF  # ops/kmer.py's SENTINEL as the int64 the device carries
MAX_K = 15             # 2k-bit codes of at most 30 bits
KERNELS = ("kmer_codes", "revcomp_kmers", "unique_counts_sorted", "subtract_sorted")
REGION_KERNEL = "region_kmers"

# kernel launches a kernel name: one per call with a non-empty input (the
# region kernel: one per call)
LAUNCHES = dict.fromkeys((*KERNELS, REGION_KERNEL), 0)
_LAUNCH = {}  # kernel name: the library's <name>_launch, at its first launch


def _launch(name: str, index: int, what, *args) -> None:
    fn = _LAUNCH.get(name)
    if fn is None:
        fn = _LAUNCH[name] = getattr(_build.library(), f"{name}_launch")
    _build.launch(fn, index, what, *args)
    LAUNCHES[name] += 1


def _on_one_card(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in ts]}; "
                         "all must be on one CUDA device")


def _dtype(name: str, t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")


def _check_k(k: int) -> None:
    """The JAX functions' one refusal of k: past 15 (k <= 0 is taken: every
    window's code is 0, and every reverse complement but SENTINEL's)."""
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds uint32 capacity (max {MAX_K})")


def kmer_codes(codes: torch.Tensor, lengths: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops.kmer.kmer_codes`` on the card: codes [R, L] int8, lengths [R]
    int32 -> (kmers [R, L - k + 1] int64, valid bool); k <= 15 and L >= k
    (at k <= 0, L - k + 1 > L windows a row, each of code 0 where it lies
    in its read)."""
    _on_one_card("kmer_codes", codes, lengths)
    _dtype("kmer_codes", codes, torch.int8, "codes")
    _dtype("kmer_codes", lengths, torch.int32, "lengths")
    _check_k(k)
    if codes.dim() != 2 or lengths.shape != codes.shape[:1]:
        raise ValueError(f"kmer_codes: codes {tuple(codes.shape)}, lengths "
                         f"{tuple(lengths.shape)}; want [R, L] and [R]")
    R, L = codes.shape
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"read length {L} shorter than k={k}")
    codes, lengths = codes.contiguous(), lengths.contiguous()
    kmers = torch.empty((R, W), dtype=torch.int64, device=codes.device)
    valid = torch.empty((R, W), dtype=torch.bool, device=codes.device)
    if R:
        _launch("kmer_codes", codes.get_device(), lambda: f"kmer_codes (R={R}, L={L}, k={k})",
                codes.data_ptr(), lengths.data_ptr(), R, L, k, kmers.data_ptr(),
                valid.data_ptr())
    return kmers, valid


def revcomp_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """``ops.kmer.revcomp_kmers`` on the card: int64 codes of any shape."""
    _on_one_card("revcomp_kmers", codes)
    _dtype("revcomp_kmers", codes, torch.int64, "codes")
    _check_k(k)
    codes = codes.contiguous()
    out = torch.empty_like(codes)
    n = codes.numel()
    if n:
        _launch("revcomp_kmers", codes.get_device(), lambda: f"revcomp_kmers (n={n}, k={k})",
                codes.data_ptr(), 1, n, k, 0, out.data_ptr())
    return out


def both_strands(codes: torch.Tensor, k: int) -> torch.Tensor:
    """``ops.kmer.both_strands`` on the card: int64 codes [..., M] ->
    [..., 2M], each row's codes and then their reverse complements, in one
    launch of the ``revcomp_kmers`` kernel."""
    _on_one_card("both_strands", codes)
    _dtype("both_strands", codes, torch.int64, "codes")
    _check_k(k)
    rows, m = _rows("both_strands", codes)
    codes = codes.contiguous()
    out = torch.empty((*codes.shape[:-1], 2 * m), dtype=torch.int64, device=codes.device)
    if rows:
        _launch("revcomp_kmers", codes.get_device(),
                lambda: f"revcomp_kmers (both strands, rows={rows}, m={m}, k={k})",
                codes.data_ptr(), rows, m, k, 1, out.data_ptr())
    return out


def _rows(name: str, t: torch.Tensor) -> Tuple[int, int]:
    if t.dim() < 1:
        raise ValueError(f"{name}: a row [N] or rows [..., N], got a scalar")
    n = t.shape[-1]
    return (t.numel() // n if n else 0), n


def unique_counts_sorted(sorted_kmers: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ops.kmer.unique_counts_sorted`` on the card: sorted int64 rows
    [..., N] -> (values int64, counts int32, is_start bool), each shaped
    like the input."""
    s = sorted_kmers
    _on_one_card("unique_counts_sorted", s)
    _dtype("unique_counts_sorted", s, torch.int64, "codes")
    rows, n = _rows("unique_counts_sorted", s)
    if n >= 1 << 31:
        raise ValueError(f"unique_counts_sorted: rows of {n} overflow the int32 counts")
    s = s.contiguous()
    values = torch.empty_like(s)
    counts = torch.empty(s.shape, dtype=torch.int32, device=s.device)
    is_start = torch.empty(s.shape, dtype=torch.bool, device=s.device)
    if rows:
        _launch("unique_counts_sorted", s.get_device(),
                lambda: f"unique_counts_sorted (rows={rows}, n={n})", s.data_ptr(), rows, n,
                values.data_ptr(), counts.data_ptr(), is_start.data_ptr())
    return values, counts, is_start


def subtract_sorted(
    sample_values: torch.Tensor,
    sample_counts: torch.Tensor,
    ref_sorted: torch.Tensor,
    normal_sorted: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops.kmer.subtract_sorted`` on the card: int64 values and int32
    counts [..., N] against sorted int64 tables [..., M] with the same
    leading dims (row g against table row g). A table of width 0 raises
    ``ValueError`` where there are queries, before anything launches, as
    the plain version and the JAX function fail on it."""
    tables = [ref_sorted] if normal_sorted is None else [ref_sorted, normal_sorted]
    _on_one_card("subtract_sorted", sample_values, sample_counts, *tables)
    _dtype("subtract_sorted", sample_values, torch.int64, "values")
    _dtype("subtract_sorted", sample_counts, torch.int32, "counts")
    for t in tables:
        _dtype("subtract_sorted", t, torch.int64, "a table")
    rows, n = _rows("subtract_sorted", sample_values)
    lead = sample_values.shape[:-1]
    if sample_counts.shape != sample_values.shape or any(
            t.dim() != sample_values.dim() or t.shape[:-1] != lead for t in tables):
        raise ValueError(
            f"subtract_sorted: values {tuple(sample_values.shape)}, counts "
            f"{tuple(sample_counts.shape)}, tables {[tuple(t.shape) for t in tables]}")
    if rows and any(t.shape[-1] == 0 for t in tables):
        raise ValueError(f"subtract_sorted: a table of width 0 "
                         f"{[tuple(t.shape) for t in tables]} against {rows * n} queries")
    values, counts = sample_values.contiguous(), sample_counts.contiguous()
    ref = ref_sorted.contiguous()
    normal = None if normal_sorted is None else normal_sorted.contiguous()
    out_values = torch.empty_like(values)
    out_counts = torch.empty_like(counts)
    if rows:
        m_ref = ref.shape[-1]
        m_normal = 0 if normal is None else normal.shape[-1]
        _launch("subtract_sorted", values.get_device(),
                lambda: f"subtract_sorted (rows={rows}, n={n}, m={m_ref}, {m_normal})",
                values.data_ptr(), counts.data_ptr(), ref.data_ptr(), m_ref,
                None if normal is None else normal.data_ptr(), m_normal, rows, n,
                out_values.data_ptr(), out_counts.data_ptr())
    return out_values, out_counts


# ---------------------------------------------------------------------------
# A serial region's sample_only_kmers in one launch (csrc/region_kmers.cu)
# ---------------------------------------------------------------------------

# csrc/region_kmers.cu's layout constants (tests/test_torch_region_kmers.py
# reads them from the source): 32 warps of uint16 offsets for 256 digits,
# 672 words of counters and tables (and 256 digit totals a CTA of the
# cluster), at most 65,535 sample windows a CTA, and the
# cluster sizes the launch takes (16 by the non-portable size)
REGION_WARPS, REGION_BINS, REGION_MISC_WORDS, REGION_MAX_KEYS = 32, 256, 672, 65535
REGION_CLUSTERS = (1, 2, 4, 8, 16)
H100_SMEM_OPTIN = 232_448  # an H100's opt-in shared memory a block (227 KB)
# the cluster sizes an H100 runs at its opt-in shared memory
# (region_kmers_max_clusters >= 1 at each, NVIDIA H100 80GB HBM3)
H100_CLUSTERS = REGION_CLUSTERS
# the cluster size a region's sample windows pay for: the last entry whose
# windows the sample reaches (tools/kmer_time.py --sweep on an NVIDIA H100
# 80GB HBM3 at 700 W, a normal of 4/5 the sample's reads: one block the
# fastest to 20 reads of 100 bases, level with 8 CTAs at 30, 8 CTAs the
# fastest at 47, 16 CTAs from 70 reads up)
CLUSTER_BY_WINDOWS = ((0, 1), (2_600, 8), (6_000, 16))


@dataclass(frozen=True)
class RegionPlan:
    """The route of one region's ``sample_only_kmers`` on the card:
    "fused" (``region_kmers``, one launch of a cluster of ``cluster``
    CTAs) where a CTA's ``smem_bytes`` fit ``limit`` and its sample windows
    fit the sort's offsets, else "per_function" (K1-K4 and ``torch.sort``;
    ``cluster`` 0, ``smem_bytes`` at the largest cluster)."""

    route: str
    smem_bytes: int
    limit: int
    windows: int
    cluster: int


def region_smem_bytes(rows: int, row_windows: int, longest: int, cluster: int = 1) -> int:
    """``region_layout(...).bytes`` of ``csrc/region_kmers.cu``, a CTA's
    shared memory for ``rows`` sample rows of ``row_windows`` windows in a
    cluster of ``cluster`` CTAs: the stage and scratch X (at least a
    CTA's rows' windows + 1 words, and a row of ``longest`` bytes in
    16-byte lines), the CTA's codes S (its rows' windows), the bit map B
    of its share of the sorted codes, the digit offsets, the counters and
    tables, and the cluster's 256 digit totals a CTA."""
    share, keys = -(-(rows * row_windows) // cluster), -(-rows // cluster) * row_windows
    x_lines = max(-(-(keys + 1) // 4), -(-(longest + 30) // 16))
    s_words = -(-keys // 4) * 4
    b_words = -(-(-(-share // 32)) // 4) * 4
    return (16 * x_lines + 4 * (s_words + b_words) + 2 * REGION_WARPS * REGION_BINS
            + 4 * (REGION_MISC_WORDS + REGION_BINS * cluster))


def region_scratch_words(ref_len: int, normal_shape: Optional[Tuple[int, int]], k: int,
                         cluster: int) -> int:
    """``region_kmers_scratch_words`` of ``csrc/region_kmers.cu``: the
    global scratch in which each CTA of a cluster leaves its share of the
    reference's and the normal's codes, then bins them (and the
    reference's reverse complements) by the CTA that owns their value: a
    CTA's 24 header words, its share of the reference's windows and of the
    normal's rows' windows (each in whole 16-byte lines), and twice the
    first and once the second for the bins; none for one block."""
    if cluster == 1:
        return 0
    R_n, L_n = normal_shape or (0, 0)
    ref_cap = -(-(-(-(ref_len - k + 1) // cluster)) // 4) * 4
    norm_cap = -(-(-(-R_n // cluster) * (L_n - k + 1 if R_n else 0)) // 4) * 4
    return cluster * (24 + 3 * ref_cap + 2 * norm_cap)


def region_cluster(windows: int) -> int:
    """The cluster size ``CLUSTER_BY_WINDOWS`` gives a sample of
    ``windows`` windows."""
    return [c for w, c in CLUSTER_BY_WINDOWS if windows >= w][-1]


def region_plan(sample_shape: Tuple[int, int], ref_len: int,
                normal_shape: Optional[Tuple[int, int]], k: int, limit: int,
                clusters: Tuple[int, ...] = H100_CLUSTERS,
                cluster: Optional[int] = None) -> RegionPlan:
    """The route and cluster size for a sample [R, L], a reference of
    ``ref_len`` bases and a normal [Rn, Ln] (None: none) at k, against
    ``limit`` bytes of shared memory a CTA and the cluster sizes
    ``clusters`` the card runs: the smallest of them, at least
    ``region_cluster``'s (or the largest there is), whose layout fits; or
    ``cluster`` alone, where given. A row has L - k + 1 windows, more than
    L at k <= 0. Shapes with L or ``ref_len`` shorter than k are the
    caller's to refuse first."""
    (R, L), ln = sample_shape, (0 if normal_shape is None else normal_shape[1])
    W = L - k + 1
    windows, longest = R * W, max(L, ref_len, ln)
    sizes = sorted(c for c in clusters if c in REGION_CLUSTERS)
    if cluster is not None:
        sizes = [c for c in sizes if c == cluster]
    elif sizes:
        least = min(region_cluster(windows), sizes[-1])
        sizes = [c for c in sizes if c >= least]
    for c in sizes:
        smem = region_smem_bytes(R, W, longest, c)
        if smem <= limit and -(-R // c) * W <= REGION_MAX_KEYS:
            return RegionPlan("fused", smem, limit, windows, c)
    widest = max(sizes or [max(REGION_CLUSTERS)])
    return RegionPlan("per_function", region_smem_bytes(R, W, longest, widest), limit,
                      windows, 0)


_SMEM_OPTIN = {}  # card index: its opt-in shared memory a block
_CLUSTERS = {}    # card index: the region kernel's cluster sizes it runs


def _index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def smem_optin(device) -> int:
    """The card's opt-in shared memory a block, in bytes (asked once)."""
    index = _index(device)
    if index not in _SMEM_OPTIN:
        _SMEM_OPTIN[index] = torch.cuda.get_device_properties(index).shared_memory_per_block_optin
    return _SMEM_OPTIN[index]


def cluster_sizes(device) -> Tuple[int, ...]:
    """The cluster sizes of ``REGION_CLUSTERS`` the card runs the region
    kernel at, at its opt-in shared memory (asked once; it builds and
    loads the kernel library, and launches nothing)."""
    index = _index(device)
    if index not in _CLUSTERS:
        lib = _build.library()
        _CLUSTERS[index] = tuple(c for c in REGION_CLUSTERS
                                 if lib.region_kmers_max_clusters(c, index) >= 1)
    return _CLUSTERS[index]


def card_plan(sample_shape, ref_len, normal_shape, k, device,
              cluster: Optional[int] = None) -> RegionPlan:
    """``region_plan`` against card ``device``'s shared memory and cluster
    sizes."""
    return region_plan(sample_shape, ref_len, normal_shape, k, smem_optin(device),
                       cluster_sizes(device), cluster)


def region_pack(sample_codes, sample_lengths, ref_codes, normal_codes=None,
                normal_lengths=None) -> Tuple[list, int]:
    """The one buffer the kernel reads, as (segments, total bytes): each
    segment (name, offset, array) starts on a 16-byte line and takes whole
    lines, so the kernel's 16-byte loads stay inside it. Segments: the
    sample's int8 codes and int32 lengths, the reference's codes and its
    length, and the normal's codes and lengths (when given)."""
    ref = np.ascontiguousarray(ref_codes, dtype=np.int8).reshape(1, -1)
    arrays = [("sample_codes", np.ascontiguousarray(sample_codes, dtype=np.int8)),
              ("sample_lengths", np.ascontiguousarray(sample_lengths, dtype=np.int32)),
              ("ref_codes", ref),
              ("ref_length", np.array([ref.shape[1]], dtype=np.int32))]
    if normal_codes is not None:
        arrays += [("normal_codes", np.ascontiguousarray(normal_codes, dtype=np.int8)),
                   ("normal_lengths", np.ascontiguousarray(normal_lengths, dtype=np.int32))]
    segments, at = [], 0
    for name, a in arrays:
        segments.append((name, at, a))
        at += -(-a.nbytes // 16) * 16
    return segments, at


_PINNED = threading.local()  # a thread's reused pinned staging buffers (and card scratch)


def _pinned(name: str, nbytes: int) -> torch.Tensor:
    buf = getattr(_PINNED, name, None)
    if buf is None or buf.numel() < nbytes:
        size = 1 << max(16, (nbytes - 1).bit_length())
        buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        setattr(_PINNED, name, buf)
    return buf[:nbytes]


def check_region(sample_codes, sample_lengths, ref_len, normal_codes, normal_lengths, k):
    """What the per-function route refuses, in its order, before anything
    launches: k, then the sample's, the reference's and the normal's
    shapes (as ``kmer_codes`` refuses them), then an empty normal table
    against sample windows (as ``subtract_sorted`` does)."""
    _check_k(k)
    sets = [(np.shape(sample_codes), np.shape(sample_lengths)), ((1, ref_len), (1,))]
    if normal_codes is not None:
        sets.append((np.shape(normal_codes), np.shape(normal_lengths)))
    for codes, lengths in sets:
        if len(codes) != 2 or tuple(lengths) != codes[:1]:
            raise ValueError(f"kmer_codes: codes {tuple(codes)}, lengths "
                             f"{tuple(lengths)}; want [R, L] and [R]")
        if codes[1] - k + 1 <= 0:
            raise ValueError(f"read length {codes[1]} shorter than k={k}")
    windows = sets[0][0][0] * (sets[0][0][1] - k + 1)
    if normal_codes is not None and windows and sets[2][0][0] == 0:
        raise ValueError(f"subtract_sorted: a table of width 0 [(1, 0)] against "
                         f"{windows} queries")


def region_kmers(sample_codes, sample_lengths, ref_codes, k: int, normal_codes=None,
                 normal_lengths=None, min_count: int = 2, *, device,
                 plan: Optional[RegionPlan] = None, cluster: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """``ops.kmer.sample_only_kmers`` on card ``device`` in one launch:
    (values uint32, counts int32) of the kept runs, ascending by value
    (the caller orders them). Raises ``ValueError`` before anything touches
    the card for what the per-function route refuses and for a region
    whose plan is not "fused" on this card. ``plan``: the caller's
    ``card_plan`` of these inputs, made after ``check_region`` (neither is
    then made again); ``cluster`` forces a cluster size (the plan made for
    it alone)."""
    if plan is None:
        ref_len = int(np.size(ref_codes))
        check_region(sample_codes, sample_lengths, ref_len, normal_codes, normal_lengths, k)
        if torch.device(device).type != "cuda":
            raise ValueError(f"region_kmers: device {device}; it runs on a CUDA device")
        plan = card_plan(np.shape(sample_codes), ref_len,
                         None if normal_codes is None else np.shape(normal_codes), k, device,
                         cluster)
    if plan.route != "fused":
        raise ValueError(f"region_kmers: a sample of {plan.windows} windows needs "
                         f"{plan.smem_bytes} bytes of shared memory a CTA"
                         f"{'' if cluster is None else f' in a cluster of {cluster}'}, the card "
                         f"has {plan.limit} (a CTA's sort takes {REGION_MAX_KEYS} windows at "
                         "most)")
    segments, total = region_pack(sample_codes, sample_lengths, ref_codes, normal_codes,
                                  normal_lengths)
    staged = region_stage(segments, total, device)
    return region_fetch(region_run(staged, segments, k, min_count, plan.windows, plan.cluster))


def _scratch(device: torch.device, words: int) -> torch.Tensor:
    """The thread's scratch on card ``device``, at least ``words`` int32
    (kept between calls: launches on one stream use it one after another)."""
    key = f"scratch{device.index}"
    buf = getattr(_PINNED, key, None)
    if buf is None or buf.numel() < words:
        buf = torch.empty(1 << max(12, (words - 1).bit_length()), dtype=torch.int32,
                          device=device)
        setattr(_PINNED, key, buf)
    return buf[:words]


def region_stage(segments, total: int, device) -> torch.Tensor:
    """The packed inputs on the card: written into the thread's pinned
    buffer, then one copy, which must end (``region_fetch`` waits for it)
    before the thread stages again."""
    host = _pinned("in", total)
    view = host.numpy()
    for _, at, a in segments:
        view[at:at + a.nbytes] = a.reshape(-1).view(np.uint8)
    return host.to(device, non_blocking=True)


REGION_PHASES = 11  # the kernel's clock stamps a CTA


def region_run(staged: torch.Tensor, segments, k: int, min_count: int, windows: int,
               cluster: int = 1, clocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of a cluster of ``cluster`` CTAs on the staged inputs ->
    the result buffer on the card, int32 [2 + 2 cap]: the kept runs, the
    runs, then (value, count) pairs. cap = windows // max(min_count, 1):
    each kept run holds at least min_count of the sample's windows. A
    cluster's CTAs share their reference and normal codes through the
    thread's scratch on the card (``region_scratch_words``).
    ``clocks``: None, or an int64 [cluster, REGION_PHASES] tensor on the
    card that takes each CTA's clock64 stamps after each phase."""
    _on_one_card(REGION_KERNEL, staged, *([] if clocks is None else [clocks]))
    if clocks is not None and (clocks.dtype != torch.int64
                               or clocks.shape != (cluster, REGION_PHASES)
                               or not clocks.is_contiguous()):
        raise ValueError(f"region_run: clocks {clocks.dtype} {tuple(clocks.shape)}; want a "
                         f"contiguous int64 [{cluster}, {REGION_PHASES}]")
    seg = {name: (at, a) for name, at, a in segments}
    base = staged.data_ptr()
    (R, L), L_r = seg["sample_codes"][1].shape, seg["ref_codes"][1].shape[1]
    normal = "normal_codes" in seg
    R_n, L_n = seg["normal_codes"][1].shape if normal else (0, 0)
    cap = windows // max(min_count, 1)
    out = torch.empty(2 + 2 * cap, dtype=torch.int32, device=staged.device)
    words = region_scratch_words(L_r, (R_n, L_n) if normal else None, k, cluster)
    scratch = _scratch(staged.device, words) if words else None
    _launch(REGION_KERNEL, staged.get_device(),
            lambda: f"region_kmers (R={R}, L={L}, L_r={L_r}, normal {R_n}x{L_n}, k={k}, "
                    f"cluster {cluster})",
            base + seg["sample_codes"][0], base + seg["sample_lengths"][0], R, L,
            base + seg["ref_codes"][0], base + seg["ref_length"][0], L_r,
            base + seg["normal_codes"][0] if normal else None,
            base + seg["normal_lengths"][0] if normal else None, R_n, L_n, k, min_count,
            out.data_ptr(), cap, None if scratch is None else scratch.data_ptr(), words, cluster,
            None if clocks is None else clocks.data_ptr())
    return out


def region_fetch(out: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """The result buffer back to the host in one copy into the thread's
    pinned buffer (which waits for the launch) -> (values uint32, counts
    int32), ascending by value."""
    host = _pinned("out", 4 * out.numel()).view(torch.int32)
    host.copy_(out)
    view = host.numpy()
    pairs = view[2:2 + 2 * int(view[0])].reshape(-1, 2)
    return pairs[:, 0].view(np.uint32).copy(), pairs[:, 1].copy()
