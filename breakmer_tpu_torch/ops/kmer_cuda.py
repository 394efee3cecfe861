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
one launch of one block (``csrc/region_kmers.cu``): host numpy in, packed
into one pinned buffer and copied to the card once, the kept (value,
count) pairs copied back once. ``region_plan`` says, from the shapes
alone and before anything touches the card, whether a region's layout
fits the block's opt-in shared memory; ``ops/kmer.py`` routes by it.
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


def _check_k(name: str, k: int) -> None:
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds uint32 capacity (max {MAX_K})")
    if k < 1:
        raise ValueError(f"{name}: k={k} < 1")


def kmer_codes(codes: torch.Tensor, lengths: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops.kmer.kmer_codes`` on the card: codes [R, L] int8, lengths [R]
    int32 -> (kmers [R, L - k + 1] int64, valid bool)."""
    _on_one_card("kmer_codes", codes, lengths)
    _dtype("kmer_codes", codes, torch.int8, "codes")
    _dtype("kmer_codes", lengths, torch.int32, "lengths")
    _check_k("kmer_codes", k)
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
    _check_k("revcomp_kmers", k)
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
    _check_k("both_strands", k)
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
# 64 words of counters, and at most 65,535 sample windows
REGION_WARPS, REGION_BINS, REGION_MISC_WORDS, REGION_MAX_KEYS = 32, 256, 64, 65535
H100_SMEM_OPTIN = 232_448  # an H100's opt-in shared memory a block (227 KB)


@dataclass(frozen=True)
class RegionPlan:
    """The route of one region's ``sample_only_kmers`` on the card:
    "fused" (``region_kmers``, one launch) where ``smem_bytes`` fit
    ``limit`` and the sample's windows fit the sort's offsets, else
    "per_function" (K1-K4 and ``torch.sort``)."""

    route: str
    smem_bytes: int
    limit: int
    windows: int


def region_smem_bytes(windows: int, longest: int) -> int:
    """``region_layout(...).bytes`` of ``csrc/region_kmers.cu``: the stage
    and scratch X (at least ``windows`` + 1 words, and a row of
    ``longest`` bytes in 16-byte lines), the sample's codes S, their bit
    map B, the digit offsets and the counters."""
    x_lines = max(-(-(windows + 1) // 4), -(-(longest + 30) // 16))
    s_words = -(-windows // 4) * 4
    b_words = -(-(-(-windows // 32)) // 4) * 4
    return (16 * x_lines + 4 * (s_words + b_words) + 2 * REGION_WARPS * REGION_BINS
            + 4 * REGION_MISC_WORDS)


def region_plan(sample_shape: Tuple[int, int], ref_len: int,
                normal_shape: Optional[Tuple[int, int]], k: int, limit: int) -> RegionPlan:
    """The route for a sample [R, L], a reference of ``ref_len`` bases and
    a normal [Rn, Ln] (None: none) at k, against ``limit`` bytes of shared
    memory a block; shapes with L or ``ref_len`` shorter than k are the
    caller's to refuse first."""
    (R, L), ln = sample_shape, (0 if normal_shape is None else normal_shape[1])
    windows = R * (L - k + 1)
    smem = region_smem_bytes(windows, max(L, ref_len, ln))
    fits = smem <= limit and windows <= REGION_MAX_KEYS
    return RegionPlan("fused" if fits else "per_function", smem, limit, windows)


_SMEM_OPTIN = {}  # card index: its opt-in shared memory a block


def smem_optin(device) -> int:
    """The card's opt-in shared memory a block, in bytes (asked once)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SMEM_OPTIN:
        _SMEM_OPTIN[index] = torch.cuda.get_device_properties(index).shared_memory_per_block_optin
    return _SMEM_OPTIN[index]


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


_PINNED = threading.local()  # a thread's reused pinned staging buffers


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
    _check_k("kmer_codes", k)
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
                 normal_lengths=None, min_count: int = 2, *, device
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """``ops.kmer.sample_only_kmers`` on card ``device`` in one launch:
    (values uint32, counts int32) of the kept runs, ascending by value
    (the caller orders them). Raises ``ValueError`` before anything touches
    the card for what the per-function route refuses and for a region
    whose plan is not "fused" on this card."""
    ref_len = int(np.size(ref_codes))
    check_region(sample_codes, sample_lengths, ref_len, normal_codes, normal_lengths, k)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"region_kmers: device {device}; it runs on a CUDA device")
    shape = np.shape(sample_codes)
    plan = region_plan(shape, ref_len, None if normal_codes is None else np.shape(normal_codes),
                       k, smem_optin(device))
    if plan.route != "fused":
        raise ValueError(f"region_kmers: a sample of {plan.windows} windows needs "
                         f"{plan.smem_bytes} bytes of shared memory a block, the card has "
                         f"{plan.limit} (the sort takes {REGION_MAX_KEYS} windows at most)")
    segments, total = region_pack(sample_codes, sample_lengths, ref_codes, normal_codes,
                                  normal_lengths)
    staged = region_stage(segments, total, device)
    return region_fetch(region_run(staged, segments, k, min_count, plan.windows))


def region_stage(segments, total: int, device) -> torch.Tensor:
    """The packed inputs on the card: written into the thread's pinned
    buffer, then one copy, which must end (``region_fetch`` waits for it)
    before the thread stages again."""
    host = _pinned("in", total)
    view = host.numpy()
    for _, at, a in segments:
        view[at:at + a.nbytes] = a.reshape(-1).view(np.uint8)
    return host.to(device, non_blocking=True)


def region_run(staged: torch.Tensor, segments, k: int, min_count: int,
               windows: int) -> torch.Tensor:
    """One launch on the staged inputs -> the result buffer on the card,
    int32 [2 + 2 cap]: the kept runs, the runs, then (value, count) pairs.
    cap = windows // max(min_count, 1): each kept run holds at least
    min_count of the sample's windows."""
    _on_one_card(REGION_KERNEL, staged)
    seg = {name: (at, a) for name, at, a in segments}
    base = staged.data_ptr()
    (R, L), L_r = seg["sample_codes"][1].shape, seg["ref_codes"][1].shape[1]
    normal = "normal_codes" in seg
    R_n, L_n = seg["normal_codes"][1].shape if normal else (0, 0)
    cap = windows // max(min_count, 1)
    out = torch.empty(2 + 2 * cap, dtype=torch.int32, device=staged.device)
    _launch(REGION_KERNEL, staged.get_device(),
            lambda: f"region_kmers (R={R}, L={L}, L_r={L_r}, normal {R_n}x{L_n}, k={k})",
            base + seg["sample_codes"][0], base + seg["sample_lengths"][0], R, L,
            base + seg["ref_codes"][0], base + seg["ref_length"][0], L_r,
            base + seg["normal_codes"][0] if normal else None,
            base + seg["normal_lengths"][0] if normal else None, R_n, L_n, k, min_count,
            out.data_ptr(), cap)
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
