"""The k-mer engine's CUDA kernels (``breakmer_tpu_torch/csrc/kmer.cu``,
wrappers ``ops/kmer_cuda.py``) without a card: the device dispatch of
``ops/kmer.py``, the wrappers' checks (with the launch made to raise if it
is reached), and numpy mirrors of each kernel's per-element algorithm
against the JAX package's functions (``breakmer_tpu.ops.kmer``) and the
port's plain versions. Exact (tolerance 0: integer outputs). The kernels
themselves run in ``tests/test_torch_cuda.py`` on a card."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from breakmer_tpu.ops import kmer as jk
from breakmer_tpu_torch.ops import kmer as tk
from breakmer_tpu_torch.ops import kmer_cuda

SENT = 0xFFFFFFFF


# -- dispatch ---------------------------------------------------------------

_FUNCTIONS = (*kmer_cuda.KERNELS, "both_strands")  # both_strands: the revcomp_kmers kernel

def _calls(device, suffix=""):
    """Each of the four functions (``suffix="_plain"``: its plain version)
    with small inputs on ``device``."""
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 5, (6, 30)).astype(np.int8)).to(device)
    lengths = torch.full((6,), 30, dtype=torch.int32).to(device)
    km = torch.sort(torch.from_numpy(rng.integers(0, 50, 40)).to(device)).values
    counts = torch.ones(40, dtype=torch.int32).to(device)
    fn = {name: getattr(tk, name + suffix) for name in _FUNCTIONS}
    return {
        "kmer_codes": lambda: fn["kmer_codes"](codes, lengths, 5),
        "revcomp_kmers": lambda: fn["revcomp_kmers"](km, 5),
        "both_strands": lambda: fn["both_strands"](km.reshape(4, 10), 5),
        "unique_counts_sorted": lambda: fn["unique_counts_sorted"](km),
        "subtract_sorted": lambda: fn["subtract_sorted"](
            km, counts, km[::3].contiguous(), km[1::4].contiguous()),
    }


@pytest.mark.parametrize("name", _FUNCTIONS)
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(name, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel wrapper")

    monkeypatch.setattr(kmer_cuda, name, refuse)
    monkeypatch.setattr(kmer_cuda, "_launch", refuse)
    before = dict(kmer_cuda.LAUNCHES)
    got = _calls("cpu")[name]()
    want = _calls("cpu", "_plain")[name]()
    got, want = ((x if isinstance(x, tuple) else (x,)) for x in (got, want))
    for a, b in zip(want, got, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert kmer_cuda.LAUNCHES == before


@pytest.mark.parametrize("name", _FUNCTIONS)
def test_other_devices_raise(name):
    with pytest.raises(ValueError, match="no implementation for device meta"):
        _calls("meta")[name]()


# -- the wrappers' checks, with the launch path made to raise ----------------

@pytest.fixture
def wrappers(monkeypatch):
    """kmer_cuda with CPU tensors let through its device check and a
    launch that raises; returns the list the refused launches go to."""
    launched = []

    def launch(name, *args):
        launched.append(name)
        raise RuntimeError(f"launch of {name} reached")

    monkeypatch.setattr(kmer_cuda, "_on_one_card", lambda name, *ts: None)
    monkeypatch.setattr(kmer_cuda, "_launch", launch)
    return launched


def test_kmer_codes_wrapper_refuses_what_the_plain_version_refuses(wrappers):
    codes = torch.zeros((3, 10), dtype=torch.int8)
    lengths = torch.full((3,), 10, dtype=torch.int32)
    with pytest.raises(ValueError, match="capacity"):
        kmer_cuda.kmer_codes(codes, lengths, 16)
    with pytest.raises(ValueError, match="shorter"):
        kmer_cuda.kmer_codes(codes, lengths, 11)
    with pytest.raises(ValueError, match="want"):
        kmer_cuda.kmer_codes(codes, lengths[:2], 5)
    with pytest.raises(ValueError, match="capacity"):
        kmer_cuda.revcomp_kmers(torch.zeros(4, dtype=torch.int64), 16)
    with pytest.raises(ValueError, match="capacity"):
        kmer_cuda.both_strands(torch.zeros(4, dtype=torch.int64), 16)
    with pytest.raises(ValueError, match="scalar"):
        kmer_cuda.both_strands(torch.zeros((), dtype=torch.int64), 5)
    assert wrappers == []


@pytest.mark.parametrize("name,call", [
    ("kmer_codes", lambda: kmer_cuda.kmer_codes(
        torch.zeros((2, 20), dtype=torch.int16), torch.zeros(2, dtype=torch.int32), 5)),
    ("kmer_codes", lambda: kmer_cuda.kmer_codes(
        torch.zeros((2, 20), dtype=torch.int8), torch.zeros(2, dtype=torch.int64), 5)),
    ("revcomp_kmers", lambda: kmer_cuda.revcomp_kmers(torch.zeros(4, dtype=torch.int32), 5)),
    ("both_strands", lambda: kmer_cuda.both_strands(torch.zeros(4, dtype=torch.int32), 5)),
    ("unique_counts_sorted", lambda: kmer_cuda.unique_counts_sorted(
        torch.zeros(4, dtype=torch.int32))),
    ("subtract_sorted", lambda: kmer_cuda.subtract_sorted(
        torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64),
        torch.zeros(4, dtype=torch.int64))),
    ("subtract_sorted", lambda: kmer_cuda.subtract_sorted(
        torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int32),
        torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int32))),
])
def test_wrappers_never_convert_a_dtype(wrappers, name, call):
    with pytest.raises(TypeError, match=name):
        call()
    assert wrappers == []


def test_subtract_wrapper_refuses_tables_of_other_rows(wrappers):
    v = torch.zeros((2, 5), dtype=torch.int64)
    c = torch.zeros((2, 5), dtype=torch.int32)
    for table in (torch.zeros((3, 4), dtype=torch.int64), torch.zeros(8, dtype=torch.int64)):
        with pytest.raises(ValueError, match="tables"):
            kmer_cuda.subtract_sorted(v, c, table)
    with pytest.raises(ValueError, match="counts"):
        kmer_cuda.subtract_sorted(v, c[:, :4], torch.zeros((2, 4), dtype=torch.int64))
    assert wrappers == []


def test_zero_size_inputs_give_empty_outputs_without_a_launch(wrappers):
    i64 = torch.int64
    km, valid = kmer_cuda.kmer_codes(torch.zeros((0, 40), dtype=torch.int8),
                                     torch.zeros(0, dtype=torch.int32), 15)
    assert km.shape == valid.shape == (0, 26) and km.dtype == i64 and valid.dtype == torch.bool
    assert kmer_cuda.revcomp_kmers(torch.zeros((3, 0), dtype=i64), 15).shape == (3, 0)
    for shape, want in (((3, 0), (3, 0)), ((0, 5), (0, 10)), ((0,), (0,))):
        out = kmer_cuda.both_strands(torch.zeros(shape, dtype=i64), 15)
        assert out.shape == want and out.dtype == i64
    for shape in ((0,), (4, 0), (0, 7)):
        out = kmer_cuda.unique_counts_sorted(torch.zeros(shape, dtype=i64))
        assert [o.shape for o in out] == [shape] * 3
        assert [o.dtype for o in out] == [i64, torch.int32, torch.bool]
        v, c = kmer_cuda.subtract_sorted(torch.zeros(shape, dtype=i64),
                                         torch.zeros(shape, dtype=torch.int32),
                                         torch.zeros((*shape[:-1], 5), dtype=i64),
                                         torch.zeros((*shape[:-1], 0), dtype=i64))
        assert v.shape == c.shape == shape and c.dtype == torch.int32
    assert wrappers == []


def test_a_non_empty_input_reaches_the_launch(wrappers):
    codes = torch.zeros((20, 2), dtype=torch.int8).t()  # a strided view
    with pytest.raises(RuntimeError, match="launch of kmer_codes reached"):
        kmer_cuda.kmer_codes(codes[:, :12], torch.full((4,), 12, dtype=torch.int32)[::2], 5)
    v = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="launch of subtract_sorted reached"):
        kmer_cuda.subtract_sorted(v, torch.zeros(3, dtype=torch.int32),
                                  torch.zeros(2, dtype=torch.int64))
    assert wrappers == ["kmer_codes", "subtract_sorted"]


@pytest.mark.parametrize("k", [0, -1, -2])
def test_k_of_no_base_reaches_the_launch(wrappers, k):
    """k <= 0, which the JAX functions and the plain versions take, is
    taken by the wrappers too: each launches its kernel (reads of 0 bases
    among them, whose L - k + 1 windows exceed L)."""
    lengths = torch.full((3,), 10, dtype=torch.int32)
    for codes in (torch.zeros((3, 10), dtype=torch.int8), torch.zeros((3, 0), dtype=torch.int8)):
        with pytest.raises(RuntimeError, match="launch of kmer_codes reached"):
            kmer_cuda.kmer_codes(codes, lengths, k)
    x = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="launch of revcomp_kmers reached"):
        kmer_cuda.revcomp_kmers(x, k)
    with pytest.raises(RuntimeError, match="launch of revcomp_kmers reached"):
        kmer_cuda.both_strands(x, k)
    assert wrappers == ["kmer_codes"] * 2 + ["revcomp_kmers"] * 2


def test_both_strands_launches_the_revcomp_kernel(wrappers):
    """The both-strand form is a launch of the revcomp_kmers kernel (and
    is counted as one), from a strided view made contiguous."""
    codes = torch.zeros((6, 8), dtype=torch.int64)[::2]
    with pytest.raises(RuntimeError, match="launch of revcomp_kmers reached"):
        kmer_cuda.both_strands(codes, 15)
    assert wrappers == ["revcomp_kmers"]


@pytest.mark.parametrize("widths", [(0, None), (0, 4), (4, 0), (0, 0)])
def test_subtract_wrapper_refuses_a_table_of_width_0(wrappers, widths):
    """Where there are queries, a table of width 0 raises before anything
    launches; the plain version raises the JAX function's TypeError."""
    v = torch.zeros((2, 3), dtype=torch.int64)
    c = torch.zeros((2, 3), dtype=torch.int32)
    ref, normal = (None if m is None else torch.zeros((2, m), dtype=torch.int64) for m in widths)
    with pytest.raises(ValueError, match="width 0"):
        kmer_cuda.subtract_sorted(v, c, ref, normal)
    with pytest.raises(TypeError, match="width 0"):
        tk.subtract_sorted_plain(v, c, ref, normal)
    assert wrappers == []


# -- the kernels' algorithms in numpy ---------------------------------------

def _cu_constants():
    """The launch shapes ``csrc/kmer.cu`` states, read from the source, so
    that the mirrors below run the kernels' own tiling."""
    text = (Path(kmer_cuda.__file__).resolve().parent.parent / "csrc" / "kmer.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
            for name in ("KMER_THREADS", "KMER_V", "SUB_THREADS", "SUB_V", "SMALL_V", "PROBES",
                         "CHUNK_PER_THREAD", "RC_THREADS", "RC_V", "UC_THREADS", "UC_V",
                         "UC_SMALL_THREADS")}


_CU = _cu_constants()
_SMS = 132  # an H100's SMs (the launch asks the card)


def _per_thread(elements: int, threads: int, v: int) -> int:
    """The launch's choice: v elements a thread, or SMALL_V where blocks of
    ``threads * v`` would leave an SM without one."""
    return v if -(-elements // (threads * v)) >= _SMS else _CU["SMALL_V"]


def _row_tiling(rows: int, n: int, prefix: str):
    """The tiling a row-tiled kernel's launch picks for rows [rows, n]:
    (threads, slots a thread): <prefix>_THREADS x <prefix>_V where that
    gives every SM a block, else <prefix>_SMALL_THREADS (where the source
    has one, else <prefix>_THREADS) x SMALL_V."""
    threads, v = _CU[f"{prefix}_THREADS"], _CU[f"{prefix}_V"]
    if rows * -(-n // (threads * v)) >= _SMS:
        return threads, v
    return _CU.get(f"{prefix}_SMALL_THREADS", threads), _CU["SMALL_V"]


def _kmer_codes_mirror(codes: np.ndarray, lengths: np.ndarray, k: int,
                       threads: int = _CU["KMER_THREADS"], per_thread: int = 0,
                       offset: int = 0, seed: int = 0):
    """kmer_codes_kernel, block by block and thread by thread. A block owns
    a span of ``threads * per_thread`` windows of the flat [R * W] output
    and stages the one run of code bytes it reads, from the 16-byte line it
    starts in (``offset``: the codes' address mod 16), zeros outside the
    run; the stage's size is held to the shared memory the launch gives.
    Per line it packs the two-bit codes (first byte on top) and the flags
    of bytes in 4..127; the words past the last line hold random bits. A
    thread computes ``per_thread`` consecutive windows: where W >=
    ``per_thread`` and the stage holds no negative byte, by shifts of 64
    bits of packed codes and 32 flag bits from its first window's first
    byte and, past its row's end, from the next row's first byte; else by
    the rolling code (k steps at its first window and at each row start,
    else one byte rolled in under the 2k-bit mask, the direct uint32 code
    for a window with a negative byte). At k <= 0 nothing is staged and a
    thread reads no byte: code 0 where w <= length - k, rolling its row's
    length in at each row start. ``per_thread`` 0: the launch's choice.
    Valid iff w <= length - k in wrapping int32 and no byte >= 4."""
    rng = np.random.default_rng(seed)
    R, L = codes.shape
    W = L - k + 1
    per_thread = per_thread or _per_thread(R * W, threads, _CU["KMER_V"])
    span = threads * per_thread
    flat = codes.reshape(-1).astype(np.int64)
    km = np.full(R * W, SENT, dtype=np.int64)
    ok = np.zeros(R * W, dtype=bool)
    mask, kmask = ((1 << (2 * k)) - 1, (1 << k) - 1) if k > 0 else (0, 0)
    # kmer_codes_lines
    cap = (span - 1 + ((span - 1) // W + 1) * (k - 1) + k + 30) // 16 + 1 if k > 0 else 0
    assert max(16 * cap + 4 * (cap + 2) + 2 * (cap + 4), 8 * span) <= 48 * 1024

    def direct(x):  # the JAX function's uint32 code of the bytes x
        acc = 0
        for b in x:
            acc = ((acc << 2) | (0 if b >= 4 else b & 0xFFFFFFFF)) & 0xFFFFFFFF
        return acc

    def lasts(r):
        return (int(lengths[r]) - k + 2 ** 31) % 2 ** 32 - 2 ** 31

    for e0 in range(0, R * W, span):
        e_end = min(e0 + span, R * W)
        if k <= 0:  # windows of no base: no stage
            for first in range(e0, e_end, per_thread):
                r, w = divmod(first, W)
                for e in range(first, min(first + per_thread, e_end)):
                    if e == first or w == 0:  # a row's length, at its first window
                        last = lasts(r)
                    ok[e] = w <= last
                    km[e] = 0 if ok[e] else SENT
                    w += 1
                    if w == W:
                        r, w = r + 1, 0
            continue
        r0, r1 = e0 // W, (e_end - 1) // W
        lo, hi = r0 * L + e0 - r0 * W, r1 * L + (e_end - 1 - r1 * W) + k
        base = lo - (lo + offset) % 16  # stage byte i is flat byte base + i
        lines = -(-(hi - base) // 16)
        assert lines <= cap
        stage = np.zeros(16 * lines, dtype=np.int64)
        stage[lo - base:hi - base] = flat[lo:hi]
        packed = [sum(int(b & 3) << (30 - 2 * j) for j, b in enumerate(stage[16 * q:16 * q + 16]))
                  for q in range(lines)] + [int(x) for x in rng.integers(0, 2 ** 32, 2)]
        bad = 0
        for i, b in enumerate(stage):
            bad |= int(4 <= b <= 127) << i
        bad |= int(rng.integers(0, 2 ** 62)) << (16 * lines)  # the flags past the last line
        fast = W >= per_thread and not (stage < 0).any()

        def byte(i):  # the rolling path reads the run only
            assert lo <= base + i < hi, (i, lo, hi)
            return stage[i]

        for first in range(e0, e_end, per_thread):
            nwin = min(per_thread, e_end - first)
            r, w = divmod(first, W)
            row = r * L - base  # stage index of (r, 0)
            if fast:
                nr = W - w
                z, flags = [], []
                for p in (row + w, row + L)[:1 + (nr < nwin)]:
                    q = p >> 4
                    x96 = packed[q] << 64 | packed[q + 1] << 32 | packed[q + 2]
                    z.append(((x96 << 2 * (p & 15)) >> 32) & (2 ** 64 - 1))
                    flags.append((bad >> p) & 0xFFFFFFFF)
                for i in range(nwin):
                    h, s = (1, i - nr) if i >= nr else (0, i)
                    pos, last = (s, lasts(r + 1)) if h else (w + i, lasts(r))
                    ok[first + i] = pos <= last and (flags[h] >> s) & kmask == 0
                    if ok[first + i]:
                        km[first + i] = (z[h] >> (64 - 2 * (s + k))) & mask
                continue
            for i in range(nwin):
                e = first + i
                if i == 0 or w == 0:
                    last, acc, bad_at, neg_at = lasts(r), 0, -1, -1
                    for j in range(k):
                        x = byte(row + w + j)
                        bad_at = w + j if x >= 4 else bad_at
                        neg_at = w + j if x < 0 else neg_at
                        acc = (acc << 2) | (x & 3)
                else:
                    x = byte(row + w + k - 1)
                    bad_at = w + k - 1 if x >= 4 else bad_at
                    neg_at = w + k - 1 if x < 0 else neg_at
                    acc = ((acc << 2) | (x & 3)) & mask
                ok[e] = w <= last and bad_at < w
                if ok[e]:
                    km[e] = direct(stage[row + w:row + w + k]) if neg_at >= w else acc
                w += 1
                if w == W:
                    r, w, row = r + 1, 0, row + L
    return km.reshape(R, W), ok.reshape(R, W)


_M64 = [np.uint64(m) for m in (0x5555555555555555, 0x3333333333333333, 0x0F0F0F0F0F0F0F0F,
                              0x00FF00FF00FF00FF, 0x0000FFFF0000FFFF, 0x00000000FFFFFFFF)]


def _brev64(y: np.ndarray) -> np.ndarray:
    """__brevll: bit i of each uint64 to bit 63 - i."""
    for i, m in enumerate(_M64):
        sh = np.uint64(1 << i)
        y = ((y >> sh) & m) | ((y & m) << sh)
    return y


def _revcomp_mirror(x: np.ndarray, k: int) -> np.ndarray:
    """revcomp (csrc/kmer.cu) per code of any int64: the 64 bits reversed,
    neighbouring bits swapped back, complemented, shifted right by 64 -
    2k (k <= 0: 0); SENTINEL kept."""
    v = np.asarray(x, dtype=np.int64)
    y = _brev64(v.astype(np.uint64))
    y = ((y >> np.uint64(1)) & _M64[0]) | ((y & _M64[0]) << np.uint64(1))
    y = ~y >> np.uint64(64 - 2 * k) if k > 0 else np.zeros_like(y)
    return np.where(v == SENT, SENT, y.astype(np.int64))


def _revcomp_kernel_mirror(x: np.ndarray, k: int, both: bool, threads: int = 0,
                           per_thread: int = 0) -> np.ndarray:
    """revcomp_kmers_kernel over rows [..., m] (``both``: the both-strand
    form, [..., 2m], a row's codes and then their reverse complements;
    else [..., m]), block by block: a tile of ``threads * per_thread``
    codes of one row, thread t's code pairs t, t + threads, ...
    (``threads`` 0: the launch's choice of both); every output slot is
    written exactly once."""
    m = x.shape[-1]
    rows = x.reshape(-1, m)
    if not threads:
        threads, per_thread = _row_tiling(len(rows), m, "RC")
    tile = threads * per_thread
    width = 2 * m if both else m
    out = np.zeros((len(rows), width), dtype=np.int64)
    written = np.zeros(out.shape, dtype=np.int64)
    pair = 2 * (np.arange(per_thread // 2)[:, None] * threads + np.arange(threads)[None, :])
    for g, row in enumerate(rows):
        for i0 in range(0, m, tile):
            for h in (0, 1):
                i = (i0 + pair + h).ravel()
                i = i[i < m]
                if both:
                    out[g, i] = row[i]
                    written[g, i] += 1
                out[g, (m if both else 0) + i] = _revcomp_mirror(row[i], k)
                written[g, (m if both else 0) + i] += 1
    assert (written == 1).all()
    return out.reshape(*x.shape[:-1], width)


def _run_end(row: np.ndarray, n: int, last: int, v: int):
    """run_end: the first index past ``last`` whose value is not v (or n),
    by one warp: probes at last + 2^lane bracket it, then rounds of 32
    probes spread over the open gap narrow it. Returns (the index, the
    rounds of loads)."""
    differ = [last + (1 << lane) >= n or row[last + (1 << lane)] != v for lane in range(32)]
    f = differ.index(True)  # lane 31 lies past the row
    lo = last + (1 << (f - 1)) if f else last
    hi = min(last + (1 << f), n)
    rounds = 1
    while hi - lo > 1:
        d = hi - lo - 1
        pos = [lo + 1 + ((d * lane) >> 5) for lane in range(32)]
        assert all(lo < q < hi for q in pos)
        dif = [row[q] != v for q in pos]
        rounds += 1
        if any(dif):
            j = dif.index(True)
            lo, hi = (pos[j - 1] if j else lo), pos[j]
        else:
            lo = pos[31]
    return hi, rounds


def _unique_counts_mirror(s: np.ndarray, threads: int = 0, per_thread: int = 0,
                          warp: int = 32):
    """unique_counts_kernel tile by tile of rows [..., n]: a tile of
    ``threads * per_thread`` slots of one row (``threads`` 0: the launch's
    choice of both), thread t's slot pairs t, t + threads, ...; a
    boundary at an index whose value differs from the one before it (lane
    0 loads that one; the other lanes take the lane before's) or at n; the
    next boundary after a pair from the first later lane of its ``warp``
    with one (a ballot), else each warp's first in the segment's later
    warps, else in the tile's later segments, else the tail: the end of
    the run of the tile's last slot, by ``_run_end`` (32 lanes, as the
    kernel's last warp). Returns (values, counts, is_start, loads: the
    slots, the slots before a pair, and the search rounds a tile)."""
    n = s.shape[-1]
    rows = s.reshape(-1, n)
    if not threads:
        threads, per_thread = _row_tiling(len(rows), n, "UC")
    cpt, tile, none = per_thread // 2, threads * per_thread, 2 ** 31 - 1
    warps = threads // warp
    values = np.full(rows.shape, SENT, dtype=np.int64)
    counts = np.zeros(rows.shape, dtype=np.int32)
    start = np.zeros(rows.shape, dtype=bool)
    loads = {"slots": 0, "before": 0, "rounds": []}
    lane = np.arange(threads) % warp
    for g, row in enumerate(rows):
        for i0 in range(0, n, tile):
            i = i0 + 2 * (np.arange(cpt)[:, None] * threads + np.arange(threads)[None, :])

            def at(idx):
                return np.where(idx < n, row[np.clip(idx, 0, n - 1)], SENT)

            ax, ay = at(i), at(i + 1)
            loads["slots"] += int((i < n).sum() + (i + 1 < n).sum())
            lead = (lane == 0) & (i > 0) & (i < n)
            loads["before"] += int(lead.sum())
            prev = np.where(lane == 0, np.where(lead, row[np.clip(i - 1, 0, n - 1)], SENT),
                            np.roll(ay, 1, axis=1))
            in0, in1 = i < n, i + 1 < n
            c0 = ~in0 | (ax != prev)
            cut = ~in1 | (ay != ax)
            st0 = in0 & (ax != SENT) & (ax != prev)
            st1 = in1 & (ay != SENT) & cut
            fb = np.where(c0, np.minimum(i, n), np.where(cut, np.minimum(i + 1, n), none))
            fbw = fb.reshape(cpt, warps, warp)
            has = fbw != none
            nb = np.full(fbw.shape, none)
            for ln in range(warp - 1):
                later = has[..., ln + 1:]
                idx = ln + 1 + later.argmax(-1)
                nb[..., ln] = np.where(later.any(-1),
                                       np.take_along_axis(fbw, idx[..., None], -1)[..., 0], none)
            first = np.where(has.any(-1), np.take_along_axis(fbw, has.argmax(-1)[..., None],
                                                              -1)[..., 0], none)
            last = i0 + tile - 1
            if last + 1 < n:
                v = row[last]
                tail, rounds = _run_end(row, n, last, v) if v != SENT else (last + 1, 0)
                loads["rounds"].append(rounds)
            else:
                tail = n
            carry = tail
            for j in range(cpt - 1, -1, -1):
                later_w = np.array([min(first[j, w + 1:], default=none) for w in range(warps)])
                after = np.minimum(np.minimum(nb[j].reshape(threads),
                                              later_w[np.arange(threads) // warp]), carry)
                carry = min(carry, int(first[j].min()))
                c0v = np.where(st0[j], np.where(cut[j], i[j] + 1, after) - i[j], 0)
                c1v = np.where(st1[j], after - i[j] - 1, 0)
                for h, ok, val, cnt, st in ((0, in0[j], ax[j], c0v, st0[j]),
                                            (1, in1[j], ay[j], c1v, st1[j])):
                    at_ = i[j][ok] + h
                    values[g, at_] = np.where(st[ok], val[ok], SENT)
                    counts[g, at_] = cnt[ok]
                    start[g, at_] = st[ok]
    return (values.reshape(s.shape), counts.reshape(s.shape), start.reshape(s.shape), loads)


def _warp_bound(t: np.ndarray, v, upper: bool, probes: int = _CU["PROBES"]) -> int:
    """warp_bound: lower_bound (upper: upper_bound) of v in the sorted t,
    N = 32 * ``probes`` probes a round at lo + d (2 j + 1) / 2N (a shift),
    the first probe right of the answer and the one before it bounding
    the next round."""
    n = 32 * probes
    shift = n.bit_length()  # log2(2N)
    lo, hi = 0, len(t)
    while lo < hi:
        d = hi - lo
        pos = [lo + ((d * (2 * j + 1)) >> shift) for j in range(n)]
        assert all(lo <= p < hi for p in pos)
        right = [t[p] > v if upper else t[p] >= v for p in pos]
        assert right == sorted(right)  # a suffix of the probes
        j = right.index(True) if any(right) else n
        lo, hi = (pos[j - 1] + 1 if j > 0 else lo), (pos[j] if j < n else hi)
    return lo


def _member_staged(s, a: int, b: int, u, found):
    """member_staged for one thread's consecutive slots u against the
    sorted s[a:b]: the thread's own part, [lower_bound(umin),
    upper_bound(umax)) of its values that are not SENTINEL, by two
    branchless searches; then each slot's branchless search of the last
    entry <= u[i] in that part. ORs found[i]."""
    real = [x for x in u if x != SENT]
    if a >= b or not real:
        return
    umin, umax = min(real), max(real)
    p = q = a
    n = b - a
    while n > 1:
        half = n >> 1
        p = p + half if s[p + half] < umin else p
        q = q + half if s[q + half] <= umax else q
        n -= half
    lo, hi = p + (s[p] < umin), q + (s[q] <= umax)
    if lo >= hi:
        return
    for i, x in enumerate(u):
        at, n = lo, hi - lo
        while n > 1:
            half = n >> 1
            at = at + half if s[at + half] <= x else at
            n -= half
        found[i] |= s[at] == x


def _subtract_mirror(values, counts, ref, normal=None, threads: int = _CU["SUB_THREADS"],
                     per_thread: int = 0, chunk: int = _CU["SUB_THREADS"] * _CU["CHUNK_PER_THREAD"],
                     probes: int = _CU["PROBES"]):
    """subtract_sorted_kernel tile by tile of rows [..., n] against table
    rows [..., m] (row g against row g): the min and max of a tile's values
    that are not SENTINEL, their range in each table row by
    ``_warp_bound``, the two ranges staged ``chunk`` entries at a time, and
    each thread's ``per_thread`` consecutive slots searched there by
    ``_member_staged``, its found flags kept across the chunks; a tile is
    ``threads * per_thread`` slots (``per_thread`` 0: the launch's
    choice). Raises where the launch refuses (a table of width 0); also
    returns the chunks each tile staged."""
    n = values.shape[-1]
    v2, c2 = values.reshape(-1, n), counts.reshape(-1, n)
    per_thread = per_thread or _per_thread(len(v2) * -(-n // (threads * _CU["SUB_V"])) *
                                           threads * _CU["SUB_V"], threads, _CU["SUB_V"])
    tile = threads * per_thread
    tables = [ref.reshape(len(v2), -1)] + ([] if normal is None else [normal.reshape(len(v2), -1)])
    if any(t.shape[-1] == 0 for t in tables):
        raise ValueError("a table of width 0")
    out_v, out_c = np.full(v2.shape, SENT, dtype=np.int64), np.zeros(v2.shape, dtype=np.int32)
    staged = []
    for g in range(len(v2)):
        for t0 in range(0, n, tile):
            v, c = v2[g, t0:t0 + tile], c2[g, t0:t0 + tile]
            real = v[v != SENT]
            found = [False] * len(v)
            staged.append(0)
            if len(real):
                lo, hi = real.min(), real.max()
                ends = [(_warp_bound(t[g], lo, False, probes), _warp_bound(t[g], hi, True, probes))
                        for t in tables]
                run = np.concatenate([t[g, a:b] for t, (a, b) in zip(tables, ends)])
                split = ends[0][1] - ends[0][0]
                for c0 in range(0, len(run), chunk):
                    staged[-1] += 1
                    s = run[c0:c0 + chunk]
                    cut = min(len(s), max(0, split - c0))
                    for i0 in range(0, len(v), per_thread):
                        u, f = list(v[i0:i0 + per_thread]), found[i0:i0 + per_thread]
                        _member_staged(s, 0, cut, u, f)
                        _member_staged(s, cut, len(s), u, f)
                        found[i0:i0 + per_thread] = f
            keep = (v != SENT) & ~np.array(found, dtype=bool)
            out_v[g, t0:t0 + tile] = np.where(keep, v, SENT)
            out_c[g, t0:t0 + tile] = np.where(keep, c, 0)
    return out_v.reshape(values.shape), out_c.reshape(values.shape), staged


def _jax_rows(fn, *rows):
    """A 1-D JAX function applied to each row of [G, N] inputs, restacked."""
    outs = [fn(*(r[g] for r in rows)) for g in range(rows[0].shape[0])]
    outs = [o if isinstance(o, tuple) else (o,) for o in outs]
    return tuple(np.stack([np.asarray(o[j]) for o in outs]) for j in range(len(outs[0])))


def _as_u32(a):
    return np.asarray(a, dtype=np.int64).astype(np.uint32)


_SMALL_SPAN = dict(threads=4, per_thread=3, offset=5)  # spans of 12 windows: many at a small size


def _held_to_jax_and_plain(codes, lengths, k, **span):
    """The kmer_codes mirror (at ``span``) equal to the JAX function and to
    the port's plain version; returns the mirror's output."""
    km, ok = _kmer_codes_mirror(codes, lengths, k, **span)
    jkm, jok = jk.kmer_codes(jnp.asarray(codes), jnp.asarray(lengths), k)
    np.testing.assert_array_equal(km, np.asarray(jkm).astype(np.int64))
    np.testing.assert_array_equal(ok, np.asarray(jok))
    pkm, pok = tk.kmer_codes_plain(torch.from_numpy(codes), torch.from_numpy(lengths), k)
    np.testing.assert_array_equal(km, pkm.numpy())
    np.testing.assert_array_equal(ok, pok.numpy())
    return km, ok


@pytest.mark.parametrize("k", [-2, -1, 0, 1, 5, 11, 15])
def test_kmer_codes_mirror_matches_jax_and_plain(k):
    rng = np.random.default_rng(k % 1000)  # (a seed >= 0)
    R, L = 24, 40
    codes = rng.integers(0, 4, (R, L)).astype(np.int8)
    codes[rng.random((R, L)) < 0.03] = rng.integers(4, 128, 1)[0]  # N as 4..127
    codes[3, :] = 4  # an all-N row
    lengths = rng.integers(0, L + 20, R).astype(np.int32)  # < k, inside, > L
    lengths[:4] = (0, k - 1, L, L + 7)
    _held_to_jax_and_plain(codes, lengths, k)


def test_kmer_codes_mirror_matches_plain_on_every_byte():
    """Every int8 value, negative ones included: no caller passes one, but
    the plain version and the kernel give the JAX function's uint32 code
    (a negative byte adds its 32-bit two's complement), not an int64 sign
    extension."""
    codes = np.arange(-128, 128, dtype=np.int16).astype(np.int8).reshape(16, 16)
    codes = np.concatenate([codes, np.tile(np.arange(4, dtype=np.int8), (16, 4))], axis=1)
    lengths = np.full(16, 80, dtype=np.int32)
    lengths[0] = np.iinfo(np.int32).min  # wraps below k
    for k in (1, 3, 15):
        for span in ({}, dict(per_thread=_CU["KMER_V"]), _SMALL_SPAN):
            km, _ = _held_to_jax_and_plain(codes, lengths, k, **span)
            assert km.min() >= 0 and km.max() <= SENT
    row = np.array([[0, 1, -1, 2, 3, 0, 1]], dtype=np.int8)
    km, _ = _held_to_jax_and_plain(row, np.array([7], dtype=np.int32), 3)
    assert km.tolist() == [[4294967295, 4294967294, 4294967291, 44, 49]]


def _span_cases():
    """Named (codes, lengths, k) at the edges of the rolling design."""
    rng = np.random.default_rng(31)

    def reads(R, L, n_rate=0.03, neg_rate=0.0):
        codes = rng.integers(0, 4, (R, L)).astype(np.int8)
        codes[rng.random((R, L)) < n_rate] = 4
        codes[rng.random((R, L)) < neg_rate] = rng.integers(-128, 0, 1)[0]
        lengths = rng.integers(L // 2, L + 3, R).astype(np.int32)
        return codes, lengths

    return {
        "spans_cross_rows": (*reads(37, 23), 5),
        "rw_not_a_multiple_of_the_span": (*reads(7, 50), 11),  # 280 windows
        "k_1": (*reads(9, 30), 1),
        "w_1": (*reads(30, 15), 15),  # L < 16: every window starts a row
        "l_under_16": (*reads(25, 9), 4),
        "contig_window": (*reads(1, 60), 15),
        "one_row_of_5000": (*reads(1, 5000, 0.002), 15),
        "poly_a_rows": (np.zeros((20, 100), np.int8), np.full(20, 100, np.int32), 15),
        "negative_bytes_rolled": (*reads(12, 64, 0.02, 0.03), 7),
        "k_0": (*reads(37, 23, 0.1, 0.05), 0),  # W = L + 1: no byte read
        "k_minus_2_reads_of_no_base": (*reads(50, 0), -2),  # W = 3 < V: many rows a thread
        "k_minus_1_lengths_past_int32": (reads(20, 7)[0], np.array(
            [0, -1, -2, 7, 8, 2**31 - 1, -2**31] * 2 + [3] * 6, np.int32), -1),
    }


@pytest.mark.parametrize("case", list(_span_cases()))
def test_kmer_codes_mirror_on_span_edges(case):
    """Each edge at the launch's own choice of span, at 8 windows a thread,
    and at spans of 12 and 21 windows (which cross rows, end ragged and
    restart the roll at every size here), with the codes off a 16-byte
    line, held to JAX and to the plain version."""
    codes, lengths, k = _span_cases()[case]
    for span in ({}, dict(per_thread=_CU["KMER_V"], offset=9), _SMALL_SPAN,
                 dict(threads=3, per_thread=7, offset=11)):
        _held_to_jax_and_plain(codes, lengths, k, **span)


def _revcomp_inputs(rng, k):
    """Codes of 2k bits (k <= 0: 0), uint32 values with bits above 2k, and
    SENTINEL."""
    top = 1 << (2 * max(k, 0))
    x = np.concatenate([rng.integers(0, top, 200), rng.integers(0, 1 << 32, 100),
                        [0, top - 1, top, SENT - 1]]).astype(np.int64)
    x[::7] = SENT
    return x


@pytest.mark.parametrize("k", range(-2, 16))
def test_revcomp_mirror_matches_jax_and_plain(k):
    """The constant-time reverse complement, for every k (k <= 0: every
    code but SENTINEL to 0): against JAX on
    uint32 codes (SENTINEL and bits above 2k included), against the plain
    version on any int64 (negative ones too), and through the kernel's
    tiling at both tile sizes."""
    rng = np.random.default_rng(k % 1000)  # (a seed >= 0)
    x = _revcomp_inputs(rng, k)
    want = np.asarray(jk.revcomp_kmers(jnp.asarray(x.astype(np.uint32)), k))
    np.testing.assert_array_equal(_revcomp_mirror(x, k).astype(np.uint32), want)
    neg = np.concatenate([x, rng.integers(-(1 << 62), 1 << 62, 50), [-1, -SENT, 1 << 40]])
    plain = tk.revcomp_kmers_plain(torch.from_numpy(neg), k).numpy()
    np.testing.assert_array_equal(_revcomp_mirror(neg, k), plain)
    for tiling in ({}, dict(threads=4, per_thread=2), dict(threads=4, per_thread=_CU["RC_V"])):
        np.testing.assert_array_equal(_revcomp_kernel_mirror(neg, k, False, **tiling), plain)


@pytest.mark.parametrize("shape", [(301,), (300,), (4, 77), (3, 1), (5, 64)])
def test_both_strands_mirror_matches_jax_and_plain(shape):
    """The both-strand form against the JAX step's expression,
    ``concatenate([x, revcomp_kmers(x, k)])`` (row by row for [G, M]), and
    the plain version, at the kernel's tiling and at small tiles."""
    rng = np.random.default_rng(sum(shape))
    for k in (-1, 0, 1, 8, 15):
        x = rng.choice(_revcomp_inputs(rng, k), shape)
        want = _jax_rows(lambda r: jnp.concatenate([r, jk.revcomp_kmers(r, k)]),
                         jnp.asarray(x.reshape(-1, shape[-1]).astype(np.uint32)))[0]
        plain = tk.both_strands_plain(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(plain.reshape(want.shape).astype(np.uint32), want)
        for tiling in ({}, dict(threads=4, per_thread=2), dict(threads=3, per_thread=4)):
            np.testing.assert_array_equal(_revcomp_kernel_mirror(x, k, True, **tiling), plain)


def _run_rows():
    """Named sorted rows [G, N] (uint32 values)."""
    rng = np.random.default_rng(11)
    s = np.uint32(SENT)
    u = np.uint32
    boundary = np.array([[1, 2, 2, 9, 9], [9, 9, 9, 10, 11], [11, s, s, s, s],
                         [11, 11, 11, 11, 11]], dtype=u)  # runs meet across rows
    random_rows = np.sort(rng.integers(0, 12, (5, 64)).astype(u), axis=1)
    random_rows[1, 50:] = s
    random_rows[2, :] = s

    def sorted_rows(G, N, hi, sent_from):
        x = np.sort(rng.integers(0, hi, (G, N)), axis=1).astype(u)
        x[:, sent_from:] = s
        return x

    return {
        "all_sentinel": np.full((1, 37), s, dtype=u),
        "all_sentinel_rows": np.full((3, 70), s, dtype=u),
        "one_run_fills_the_row": np.full((1, 1000), 3, dtype=u),
        "poly_a_rows": np.zeros((3, 200), dtype=u),
        "run_ends_at_the_row_end": np.array([[0, 4, 7, 7, 7, 7, 7, 7, 7]], dtype=u),
        "run_ends_at_the_first_sentinel": np.array([[5, 5, 5, s, s]], dtype=u),
        "single_element": np.array([[42]], dtype=u),
        "single_sentinel": np.array([[s]], dtype=u),
        "n_1_rows": np.array([[5], [s], [5]], dtype=u),
        "runs_meet_at_row_boundaries": boundary,
        "random_rows": random_rows,
        "runs_of_every_length": np.sort(np.repeat(np.arange(40, dtype=u),
                                                  np.arange(1, 41)))[None, :],
        "runs_cross_one_tile": sorted_rows(3, 500, 40, 470),
        "runs_cross_many_tiles": sorted_rows(2, 300, 3, 300),
        "ragged_last_tile": sorted_rows(2, 86, 30, 80),
        "sentinel_from_inside_a_tile": sorted_rows(2, 64, 9, 37),
    }


# small tiles (the kernel's arithmetic at the sizes a test can hold): 32
# and 16 slots of warps of 4, and 4 slots of one warp
_SMALL_RUN_TILES = [dict(threads=8, per_thread=4, warp=4), dict(threads=8, per_thread=2, warp=4),
                    dict(threads=2, per_thread=2, warp=2)]


@pytest.mark.parametrize("case", list(_run_rows()))
def test_unique_counts_mirror_matches_jax(case):
    """The tile scan at the kernel's tiling and at small tiles, against JAX
    row by row and the plain version."""
    rows = _run_rows()[case]
    want = _jax_rows(jk.unique_counts_sorted, *[jnp.asarray(rows)])
    got = tk.unique_counts_sorted_plain(torch.from_numpy(rows.astype(np.int64)))
    for tiling in ({}, *_SMALL_RUN_TILES):
        v, c, st, _ = _unique_counts_mirror(rows.astype(np.int64), **tiling)
        np.testing.assert_array_equal(_as_u32(v), want[0])
        np.testing.assert_array_equal(c, want[1])
        np.testing.assert_array_equal(st, want[2])
        for a, b in zip((v, c, st), got):
            np.testing.assert_array_equal(a, b.numpy())


def test_unique_counts_search_is_logarithmic_in_the_run():
    """The loads of the tile scan at a serial region's 17,200 slots: each
    slot once, one slot before a pair a warp and segment, and one search a
    tile but the row's last, whose rounds of 32 probes grow as log2 of the
    run's length past the tile over 5: a poly-A region's single k-mer of
    R * W copies costs at most 1 + ceil(log2(N) / 5) = 4 rounds a tile,
    not a search from every run start; short runs cost 1."""
    n = 200 * 86
    threads, per_thread = _row_tiling(1, n, "UC")
    tiles = -(-n // (threads * per_thread))
    for rows, most in ((np.zeros((1, n), dtype=np.int64), 1 + int(np.ceil(np.log2(n) / 5))),
                       (np.repeat(np.arange(10), [1, 2, 3, 7, 13, 100, 1000, 2000, 4000, 10074])
                        [None, :], 4),
                       (np.sort(np.random.default_rng(1).integers(0, 6000, (1, n))), 2)):
        _, c, _, loads = _unique_counts_mirror(rows)
        np.testing.assert_array_equal(c, tk.unique_counts_sorted_plain(
            torch.from_numpy(rows))[1].numpy())
        assert loads["slots"] == n
        assert loads["before"] <= tiles * per_thread // 2 * threads // 32
        assert len(loads["rounds"]) == tiles - 1  # every tile but the row's last
        assert max(loads["rounds"]) <= most
    _, c, _, loads = _unique_counts_mirror(np.zeros((1, n), dtype=np.int64))
    assert c[0, 0] == n and int(c.sum()) == n
    assert min(loads["rounds"]) >= 2  # the run goes on past every tile


def _tables(rng, values, m, hit_rate):
    """Sorted table rows [G, m] holding about ``hit_rate`` of each row's
    values, the rest random codes, SENTINEL padding last."""
    out = []
    for row in values.reshape(-1, values.shape[-1]):
        real = row[row != SENT]
        pick = real[rng.random(len(real)) < hit_rate]
        t = np.concatenate([pick, rng.integers(0, 60, m)])[:m]
        t = np.sort(np.concatenate([t, np.full(m - len(t), SENT)]))
        out.append(t)
    return np.stack(out).reshape(*values.shape[:-1], m).astype(np.int64)


def _subtract_held(v, c, ref, normal=None, **tiling):
    """The subtract mirror (at ``tiling``) equal to the JAX function, row
    by row, and to the plain version; returns the mirror's output."""
    got = _subtract_mirror(v, c, ref, normal, **tiling)
    want = _jax_rows(jk.subtract_sorted, *[jnp.asarray(a) for a in (
        _as_u32(v), c, _as_u32(ref), *([] if normal is None else [_as_u32(normal)]))])
    np.testing.assert_array_equal(got[0], want[0].astype(np.int64))
    np.testing.assert_array_equal(got[1], want[1])
    plain = tk.subtract_sorted_plain(*(torch.from_numpy(a) for a in (v, c, ref)),
                                      None if normal is None else torch.from_numpy(normal))
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b.numpy())
    return got


_SMALL_TILE = dict(threads=4, per_thread=4, chunk=8, probes=1)


@pytest.mark.parametrize("G,with_normal", [(1, False), (1, True), (4, True)])
def test_subtract_mirror_matches_jax(G, with_normal):
    rng = np.random.default_rng(G + 2 * with_normal)
    raw = np.sort(rng.integers(0, 60, (G, 80)), axis=1)
    raw[:, 70:] = SENT
    v, c, _, _ = _unique_counts_mirror(raw.astype(np.int64))
    ref = _tables(rng, v, 30, 0.3)
    normal = _tables(rng, v, 17, 0.2) if with_normal else None
    for tiling in ({}, _SMALL_TILE):
        got = _subtract_held(v, c, ref, normal, **tiling)
        assert 0 < int((got[0] != SENT).sum()) < int((v != SENT).sum())


def test_subtract_mirror_on_sentinel_and_empty_tables():
    """All-SENTINEL tables subtract nothing (against JAX and the plain
    version); a table of width 0 is refused where there are queries, as
    JAX and the plain version refuse it (TypeError both)."""
    rng = np.random.default_rng(5)
    raw = np.sort(rng.integers(0, 30, (2, 40)), axis=1)
    raw[1, 25:] = SENT
    v, c, _, _ = _unique_counts_mirror(raw.astype(np.int64))
    sent_table = np.full((2, 9), SENT, dtype=np.int64)
    for tiling in ({}, _SMALL_TILE):
        got = _subtract_held(v, c, sent_table, sent_table, **tiling)
        np.testing.assert_array_equal(got[0], v)
    empty = np.zeros((2, 0), dtype=np.int64)
    ref = np.sort(np.stack([rng.choice(30, 8, replace=False) for _ in v]), axis=1)
    for r, normal in ((ref, empty), (empty, None), (empty, empty)):
        with pytest.raises(ValueError, match="width 0"):
            _subtract_mirror(v, c, r, normal)
        with pytest.raises(TypeError, match="width 0"):
            tk.subtract_sorted_plain(*(torch.from_numpy(a) for a in (v, c, r)),
                                     None if normal is None else torch.from_numpy(normal))
    with pytest.raises(TypeError):
        jk.subtract_sorted(jnp.asarray(_as_u32(v[0])), jnp.asarray(c[0]),
                           jnp.asarray(_as_u32(empty[0])))


def _tile_cases():
    """Named (values, counts, ref, normal) at the edges of the tile design."""
    rng = np.random.default_rng(41)

    def counted(G, N, hi, sent_from):
        raw = np.sort(rng.integers(0, hi, (G, N)), axis=1)
        raw[:, sent_from:] = SENT
        return _unique_counts_mirror(raw.astype(np.int64))[:2]

    v, c = counted(2, 3000, 2000, 2600)
    dense = np.sort(rng.choice(2000, (2, 12000), replace=True), axis=1).astype(np.int64)
    shuffled = v.copy()
    for row in shuffled:
        rng.shuffle(row)
    pv, pc = _unique_counts_mirror(np.zeros((3, 700), dtype=np.int64))[:2]
    ov, oc = counted(1, 2049, 500, 2049)
    return {
        # tables of 12,000 and 24,000 entries over the values' 2,000 codes:
        # more than a chunk of entries in a tile's range at either tiling
        "range_wider_than_a_chunk": (v, c, dense, np.sort(np.concatenate([dense, dense], 1))),
        "unsorted_queries": (shuffled, c, _tables(rng, v, 400, 0.4), _tables(rng, v, 300, 0.2)),
        "tiles_of_sentinel_alone": (*counted(2, 6200, 900, 1500), _tables(rng, v[:, :1], 50, 0),
                                    None),
        "poly_a": (pv, pc, np.array([[0, 5, SENT]] * 3, dtype=np.int64),
                   np.array([[1, 2]] * 3, dtype=np.int64)),
        "poly_a_not_in_the_tables": (pv, pc, np.array([[1, 5, SENT]] * 3, dtype=np.int64), None),
        "odd_n": (ov, oc, _tables(rng, ov, 77, 0.3), _tables(rng, ov, 31, 0.3)),
    }


@pytest.mark.parametrize("case", list(_tile_cases()))
def test_subtract_mirror_on_tile_edges(case):
    """Each edge at the kernel's own tiling and at tiles of 16 slots with
    chunks of 8 entries, held to JAX and to the plain version."""
    v, c, ref, normal = _tile_cases()[case]
    for tiling in ({}, _SMALL_TILE, dict(per_thread=_CU["SUB_V"])):
        got = _subtract_held(v, c, ref, normal, **tiling)
        if case == "range_wider_than_a_chunk":
            assert max(got[2]) > 1
        if case == "tiles_of_sentinel_alone":
            assert min(got[2]) == 0


@pytest.mark.parametrize("probes", [1, 2, 8])
def test_warp_bound_matches_searchsorted(probes):
    rng = np.random.default_rng(3)
    for m in (1, 2, 32, 33, 34, 256, 257, 258, 1089, 29184, 66049, 70000):
        t = np.sort(rng.integers(0, 3 * m, m))
        for v in (*rng.integers(-2, 3 * m + 2, 20), t[0], t[-1]):
            assert _warp_bound(t, v, False, probes) == np.searchsorted(t, v, "left")
            assert _warp_bound(t, v, True, probes) == np.searchsorted(t, v, "right")


@pytest.mark.parametrize("order", ["ascending", "any"])
def test_member_staged_matches_isin(order):
    """Slots with SENTINEL gaps, ascending (the merge) or in any order (a
    binary search each), against np.isin over every width."""
    rng = np.random.default_rng(4)
    for n in (1, 2, 3, 7, 8, 9, 255, 2048):
        s = np.sort(rng.integers(0, 2 * n, n))
        for _ in range(20):
            u = rng.integers(-1, 2 * n + 1, 8)
            u[rng.random(8) < 0.3] = SENT
            if order == "ascending":
                u[u != SENT] = np.sort(u[u != SENT])
            found = [False] * 8
            _member_staged(s, 0, n, list(u), found)
            assert found == [bool(x != SENT and np.isin(x, s)) for x in u]
