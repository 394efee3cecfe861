"""Wrappers of the hand-written CUDA kernels of the k-mer engine
(``csrc/kmer.cu``): ``kmer_codes``, ``revcomp_kmers``,
``unique_counts_sorted`` and ``subtract_sorted`` of ``ops/kmer.py`` on
CUDA tensors, one launch a call, as XLA runs each of the jitted functions
of ``breakmer_tpu/ops/kmer.py`` as one program.

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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from breakmer_tpu_torch import _build

SENTINEL = 0xFFFFFFFF  # ops/kmer.py's SENTINEL as the int64 the device carries
MAX_K = 15             # 2k-bit codes of at most 30 bits
KERNELS = ("kmer_codes", "revcomp_kmers", "unique_counts_sorted", "subtract_sorted")

# kernel launches a kernel name: one per call with a non-empty input
LAUNCHES = dict.fromkeys(KERNELS, 0)
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
                codes.data_ptr(), n, k, out.data_ptr())
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
    leading dims (row g against table row g); a table of width 0 holds
    nothing."""
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
