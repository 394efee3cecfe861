"""K-mer extraction, counting, and set subtraction — the Jellyfish
replacement.

Port of ``breakmer_tpu/ops/kmer.py``. A k-mer is a 2k-bit integer code
(k <= 15 fits 30 bits). Extraction is k shift-or steps over a padded
[R, L] base-code tensor; counting and subtraction are sort + segmented
run-length + binary-search ops over flat code vectors, with invalid slots
carried as a sentinel code that sorts to the end.

The JAX package jits each of these functions, so each call is one XLA
program. Here ``kmer_codes``, ``revcomp_kmers``, ``unique_counts_sorted``
and ``subtract_sorted`` dispatch by device: a CUDA tensor goes to the
function's hand-written kernel (``ops/kmer_cuda.py``, ``csrc/kmer.cu``:
one launch a call), which launches or raises; a CPU tensor goes to its
plain torch version (``*_plain``, the JAX body op for op), and any other
device raises. ``both_strands`` is the JAX package's both-strand table
expression, ``concatenate([x, revcomp_kmers(x, k)])``, which XLA runs as
one program: on the card one launch of the ``revcomp_kmers`` kernel.
``member_sorted`` is the plain half of ``subtract_sorted``;
``sort_kmers`` and the reference table's sort stay ``torch.sort``, as the
JAX package leaves its sorts to XLA's.

``sample_only_kmers``, the serial path's call a region, takes one of two
routes on a card, chosen from the shapes and the card's limits before
anything launches (``kmer_cuda.region_plan``): the whole composite in one
launch of one thread-block cluster (``kmer_cuda.region_kmers``,
``csrc/region_kmers.cu``: codes, sort, run counts and subtraction in the
CTAs' shared memory) where the region fits a cluster size the card runs,
else the chain of the functions above ("per_function"). That
route gives up "one launch a function, as XLA runs it" for this
composite alone; no error gives way from one route to the other.

On the device the codes are carried as int64 (torch has no uint32
``searchsorted``, ``<<`` or ``max`` on the CPU); SENTINEL = 0xFFFFFFFF
still sorts after every code of 30 bits or fewer. The host wrappers
(``sample_only_kmers``, ``kmer_table``, ``novel_kmer_normal_support``)
convert back to ``np.uint32``, so the assembler sees exactly what the
JAX package gives it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from breakmer_tpu_torch.ops import kmer_cuda

# Sentinel for invalid/padded kmer slots: max uint32, sorts after any real
# 2k-bit code (codes use at most 30 bits for k<=15). Host numpy scalar;
# the device tensors use the same value as int64.
SENTINEL = np.uint32(0xFFFFFFFF)
_SENT = int(SENTINEL)
MAX_K_U32 = 15


def kmer_codes_plain(codes: torch.Tensor, lengths: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extract all k-mer codes from a padded read batch.

    Args:
      codes:   [R, L] int8 base codes (0..3 real, 4 = N/pad).
      lengths: [R] int32 true read lengths.
      k:       k-mer size (<= 15).

    Returns:
      (kmers [R, L-k+1] int64, valid [R, L-k+1] bool). A window is valid
      iff it lies within the read and contains no N. Invalid slots hold
      SENTINEL.
    """
    if k > MAX_K_U32:
        raise ValueError(f"k={k} exceeds uint32 capacity (max {MAX_K_U32})")
    R, L = codes.shape
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"read length {L} shorter than k={k}")
    acc = torch.zeros((R, W), dtype=torch.int64, device=codes.device)
    bad = torch.zeros((R, W), dtype=torch.bool, device=codes.device)
    for j in range(k):
        window = codes[:, j : j + W]
        is_n = window >= 4
        bad |= is_n
        # the JAX function's uint32 arithmetic: a negative byte (no caller
        # passes one) wraps as it does there
        acc = ((acc << 2) | window.masked_fill(is_n, 0).to(torch.int64)) & _SENT
    pos = torch.arange(W, dtype=torch.int32, device=codes.device)[None, :]
    in_read = pos <= (lengths.to(torch.int32)[:, None] - k)
    valid = in_read & ~bad
    return acc.masked_fill(~valid, _SENT), valid


def kmer_codes_np(codes: np.ndarray, lengths: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact host-numpy twin of :func:`kmer_codes` (tested for equality).

    The assembler needs the per-read k-mer codes on the HOST to build
    posting lists; for the few hundred short reads of a region a numpy
    evaluation takes microseconds, where a device call would add a copy
    of the reads to the card and of the codes back for a result that only
    the host uses.
    """
    if k > MAX_K_U32:
        raise ValueError(f"k={k} exceeds uint32 capacity (max {MAX_K_U32})")
    codes = np.asarray(codes, dtype=np.int8)
    lengths = np.asarray(lengths, dtype=np.int32)
    R, L = codes.shape
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"read length {L} shorter than k={k}")
    acc = np.zeros((R, W), dtype=np.uint32)
    bad = np.zeros((R, W), dtype=bool)
    for j in range(k):
        window = codes[:, j : j + W]
        bad |= window >= 4
        acc = (acc << np.uint32(2)) | np.where(window >= 4, 0, window).astype(np.uint32)
    pos = np.arange(W, dtype=np.int32)[None, :]
    valid = (pos <= (lengths[:, None] - k)) & ~bad
    return np.where(valid, acc, SENTINEL), valid


def revcomp_kmers_plain(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse-complement packed int64 k-mer codes on the device
    (SENTINEL maps to SENTINEL)."""
    c = codes
    out = torch.zeros_like(c)
    for _ in range(k):
        # the JAX function's uint32 arithmetic: past k = 16 the code wraps
        out = ((out << 2) | (3 - (c & 3))) & _SENT
        c = c >> 2
    return out.masked_fill(codes == _SENT, _SENT)


def both_strands_plain(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Codes [..., M] -> [..., 2M]: each row's codes, then their reverse
    complements (SENTINEL stays SENTINEL)."""
    return torch.cat([codes, revcomp_kmers_plain(codes, k)], dim=-1)


def sort_kmers(kmers: torch.Tensor, start_dim: int = 0) -> torch.Tensor:
    """Flatten and sort kmer codes; SENTINEL (invalid) slots sort last.
    ``start_dim=1`` keeps the leading (region) dim: [G, ...] -> [G, N],
    each row sorted (the batched form of the JAX step's ``vmap``)."""
    return torch.sort(kmers.flatten(start_dim), dim=-1).values


def unique_counts_sorted_plain(sorted_kmers: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run-length encode a sorted code vector (static shape), along the
    last dim: [N], or [G, N] with each row sorted.

    Returns (values, counts int32, is_start), each shaped like the input:
    at each run start, ``values`` holds the k-mer and ``counts`` its
    multiplicity; elsewhere values=SENTINEL, counts=0.
    """
    s = sorted_kmers
    n = s.shape[-1]
    lead = s.shape[:-1]
    prev = torch.cat([s.new_full((*lead, 1), _SENT), s[..., :-1]], dim=-1)
    is_start = (s != prev) & (s != _SENT)
    idx = torch.arange(n, dtype=torch.int64, device=s.device)
    # run end = next run's start (or first sentinel position), per row
    total_valid = (s != _SENT).sum(dim=-1, keepdim=True)
    # next start after each position: reverse running min
    starts = torch.where(is_start, idx, n)
    nxt = torch.cummin(starts.flip(-1), dim=-1).values.flip(-1)
    nxt_after = torch.cat([nxt[..., 1:], idx.new_full((*lead, 1), n)], dim=-1)
    run_end = torch.minimum(torch.where(nxt_after > idx, nxt_after, n), total_valid)
    counts = torch.where(is_start, run_end - idx, 0).to(torch.int32)
    values = s.masked_fill(~is_start, _SENT)
    return values, counts, is_start


def member_sorted(queries: torch.Tensor, table_sorted: torch.Tensor) -> torch.Tensor:
    """For each query code, True iff present in the sorted table.

    ``table_sorted`` may contain SENTINEL padding (sorts last). SENTINEL
    queries return False. Batched form: queries [G, N] against tables
    [G, M], row g against table g. A table of width 0 against queries
    raises ``TypeError``, as the JAX function's gather refuses it.
    """
    if table_sorted.shape[-1] == 0 and queries.numel():
        raise TypeError(f"member_sorted: a table of width 0 {tuple(table_sorted.shape)} "
                        f"against {queries.numel()} queries")
    pos = torch.searchsorted(table_sorted, queries)
    pos = pos.clamp(0, table_sorted.shape[-1] - 1)
    hit = table_sorted.gather(-1, pos) == queries
    return hit & (queries != _SENT)


def subtract_sorted_plain(
    sample_values: torch.Tensor,
    sample_counts: torch.Tensor,
    ref_sorted: torch.Tensor,
    normal_sorted: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """sample_only = sample - reference [- normal], with counts preserved.
    Returns (values, counts) with removed entries set to (SENTINEL, 0).
    Batched form: [G, N] samples against [G, M] tables, row by row."""
    drop = member_sorted(sample_values, ref_sorted)
    if normal_sorted is not None:
        drop = drop | member_sorted(sample_values, normal_sorted)
    keep = (~drop) & (sample_values != _SENT)
    return (
        sample_values.masked_fill(~keep, _SENT),
        sample_counts.masked_fill(~keep, 0),
    )


# ---------------------------------------------------------------------------
# Device dispatch: the kernel on a CUDA tensor (it launches or raises), the
# plain version on a CPU tensor, identical results either way.
# ---------------------------------------------------------------------------

def _pick(name: str, x: torch.Tensor, kernel, plain):
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"{name}: no implementation for device {x.device}")


def kmer_codes(codes: torch.Tensor, lengths: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`kmer_codes_plain`'s contract, dispatched by ``codes``' device."""
    return _pick("kmer_codes", codes, kmer_cuda.kmer_codes, kmer_codes_plain)(
        codes, lengths, k)


def revcomp_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`revcomp_kmers_plain`'s contract, dispatched by device."""
    return _pick("revcomp_kmers", codes, kmer_cuda.revcomp_kmers, revcomp_kmers_plain)(
        codes, k)


def both_strands(codes: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`both_strands_plain`'s contract, dispatched by device."""
    return _pick("both_strands", codes, kmer_cuda.both_strands, both_strands_plain)(codes, k)


def unique_counts_sorted(sorted_kmers: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`unique_counts_sorted_plain`'s contract, dispatched by device."""
    return _pick("unique_counts_sorted", sorted_kmers, kmer_cuda.unique_counts_sorted,
                 unique_counts_sorted_plain)(sorted_kmers)


def subtract_sorted(
    sample_values: torch.Tensor,
    sample_counts: torch.Tensor,
    ref_sorted: torch.Tensor,
    normal_sorted: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`subtract_sorted_plain`'s contract, dispatched by
    ``sample_values``' device (a table of width 0 is refused where there
    are queries: the plain version raises ``TypeError``, as the JAX
    function's gather does, the card wrapper ``ValueError`` before it
    launches)."""
    return _pick("subtract_sorted", sample_values, kmer_cuda.subtract_sorted,
                 subtract_sorted_plain)(sample_values, sample_counts, ref_sorted, normal_sorted)


# ---------------------------------------------------------------------------
# Host-side wrappers (used by the per-region pipeline, which is host-driven
# between device stages): numpy in, numpy uint32 codes out.
# ---------------------------------------------------------------------------

def _to_dev(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def _to_u32(codes: torch.Tensor) -> np.ndarray:
    return codes.cpu().numpy().astype(np.uint32)


# sample_only_kmers calls on a card by route: "fused" (one launch of
# kmer_cuda.region_kmers) or "per_function" (K1-K4 and torch.sort)
ROUTES = {"fused": 0, "per_function": 0}


def _sample_only_chain(fns, sample_codes, sample_lengths, ref_codes, k, normal_codes,
                       normal_lengths, device):
    """The JAX composite's chain through ``fns`` (kmer_codes,
    unique_counts_sorted, both_strands, subtract_sorted): the sample's
    (values, counts) less both tables, on ``device``."""
    codes, unique, strands, subtract = fns
    s_km, _ = codes(_to_dev(sample_codes, np.int8, device),
                    _to_dev(sample_lengths, np.int32, device), k)
    values, counts, _ = unique(sort_kmers(s_km))

    ref = np.asarray(ref_codes, dtype=np.int8).reshape(1, -1)
    r_km, _ = codes(_to_dev(ref, np.int8, device), _to_dev([ref.shape[1]], np.int32, device), k)
    # both strands: a sample read may come from either strand, so a k-mer
    # and its reverse complement both count as reference-present
    ref_table = torch.sort(strands(r_km.reshape(-1), k)).values

    normal_table = None
    if normal_codes is not None:
        n_km, _ = codes(_to_dev(normal_codes, np.int8, device),
                        _to_dev(normal_lengths, np.int32, device), k)
        normal_table = sort_kmers(n_km)

    values, counts = subtract(values, counts, ref_table, normal_table)
    v = _to_u32(values)
    c = counts.cpu().numpy()
    keep = v != np.uint32(0xFFFFFFFF)
    return v[keep], c[keep]


def _by_count(v: np.ndarray, c: np.ndarray, min_count: int) -> Tuple[np.ndarray, np.ndarray]:
    keep = c >= min_count
    v, c = v[keep], c[keep]
    # deterministic order: count desc, then code asc (parity tie-break)
    order = np.lexsort((v, -c.astype(np.int64)))
    return v[order], c[order]


_PLAIN = (kmer_codes_plain, unique_counts_sorted_plain, both_strands_plain,
          subtract_sorted_plain)
_DISPATCHED = (kmer_codes, unique_counts_sorted, both_strands, subtract_sorted)


def sample_only_kmers_plain(
    sample_codes: np.ndarray,
    sample_lengths: np.ndarray,
    ref_codes: np.ndarray,
    k: int,
    normal_codes: Optional[np.ndarray] = None,
    normal_lengths: Optional[np.ndarray] = None,
    min_count: int = 2,
    *,
    device="cpu",
) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`sample_only_kmers`'s contract by the chain of the plain
    versions (torch ops only, on any device): the CPU path, and what the
    card's kernels are held to."""
    return _by_count(*_sample_only_chain(_PLAIN, sample_codes, sample_lengths, ref_codes, k,
                                         normal_codes, normal_lengths, device), min_count)


def sample_only_kmers(
    sample_codes: np.ndarray,
    sample_lengths: np.ndarray,
    ref_codes: np.ndarray,
    k: int,
    normal_codes: Optional[np.ndarray] = None,
    normal_lengths: Optional[np.ndarray] = None,
    min_count: int = 2,
    *,
    device,
    route: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full pipeline on ``device``: extract -> count -> subtract ->
    threshold. Returns (kmer_codes uint32 sorted desc by count then asc by
    code, counts int32), host numpy arrays ready for the assembler.

    On the CPU it is :func:`sample_only_kmers_plain`. On a card the route
    is ``kmer_cuda.card_plan``'s, chosen from the shapes and the card's
    limits before anything launches, or ``route`` where given: "fused" is
    one launch of ``kmer_cuda.region_kmers`` (a cluster of the plan's size;
    it raises ``ValueError`` before any launch for a region that does not
    fit), "per_function" the kernels K1-K4 and ``torch.sort``. The checks
    and the plan run once a call. Each card call counts in ``ROUTES``."""
    device = torch.device(device)
    if device.type == "cpu":
        return sample_only_kmers_plain(sample_codes, sample_lengths, ref_codes, k, normal_codes,
                                       normal_lengths, min_count, device=device)
    if device.type != "cuda":
        raise ValueError(f"sample_only_kmers: no implementation for device {device}")
    plan = None
    if route is None:
        ref_len = int(np.size(ref_codes))
        kmer_cuda.check_region(sample_codes, sample_lengths, ref_len, normal_codes,
                               normal_lengths, k)
        plan = kmer_cuda.card_plan(np.shape(sample_codes), ref_len,
                                   None if normal_codes is None else np.shape(normal_codes), k,
                                   device)
        route = plan.route
    if route == "fused":
        v, c = kmer_cuda.region_kmers(sample_codes, sample_lengths, ref_codes, k, normal_codes,
                                      normal_lengths, min_count, device=device, plan=plan)
    elif route == "per_function":
        v, c = _sample_only_chain(_DISPATCHED, sample_codes, sample_lengths, ref_codes, k,
                                  normal_codes, normal_lengths, device)
    else:
        raise ValueError(f"sample_only_kmers: route {route!r}; want 'fused' or 'per_function'")
    ROUTES[route] += 1
    return _by_count(v, c, min_count)


def kmer_table(
    codes: np.ndarray, lengths: np.ndarray, k: int, add_rc: bool = True,
    *, device,
) -> np.ndarray:
    """Sorted k-mer membership table (host numpy uint32) over a read batch
    or a single sequence row; with ``add_rc`` the table is orientation-
    proof (contains every k-mer's reverse complement too). The codes,
    their reverse complements and the sort run on ``device``; the sorted
    table comes back in one copy."""
    km, _ = kmer_codes(_to_dev(codes, np.int8, device),
                       _to_dev(lengths, np.int32, device), k)
    v = km[km != _SENT]
    if add_rc:
        v = both_strands(v, k)
    return _to_u32(torch.sort(v).values)


def _member_host(values: np.ndarray, table: np.ndarray) -> np.ndarray:
    if len(table) == 0:
        return np.zeros(len(values), dtype=bool)
    idx = np.searchsorted(table, values).clip(0, len(table) - 1)
    return table[idx] == values


def novel_kmer_normal_support(
    contig_codes: np.ndarray,
    ref_table: np.ndarray,
    normal_table: np.ndarray,
    k: int,
    *,
    device,
) -> Tuple[int, int]:
    """(n_novel, n_in_normal) for one contig: how many of the contig's
    non-reference (novel) k-mers appear in the matched normal (the
    post-assembly germline recheck; see breakmer_tpu.ops.kmer)."""
    row = np.asarray(contig_codes, dtype=np.int8).reshape(1, -1)
    km, _ = kmer_codes(_to_dev(row, np.int8, device),
                       _to_dev([row.shape[1]], np.int32, device), k)
    v = _to_u32(km).reshape(-1)
    v = np.unique(v[v != SENTINEL])
    novel = v[~_member_host(v, ref_table)]
    if len(novel) == 0:
        return 0, 0
    return len(novel), int(np.sum(_member_host(novel, normal_table)))


def kmer_to_str(code: int, k: int) -> str:
    """Decode a k-mer code back to its ACGT string (debug/report aid)."""
    bases = "ACGT"
    out = []
    for shift in range(2 * (k - 1), -2, -2):
        out.append(bases[(int(code) >> shift) & 3])
    return "".join(out)


def str_to_kmer(s: str) -> int:
    code = 0
    lut = {"A": 0, "C": 1, "G": 2, "T": 3}
    for ch in s.upper():
        code = (code << 2) | lut[ch]
    return code
