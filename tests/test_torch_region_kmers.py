"""A serial region's k-mer call on the CPU: the port's ``sample_only_kmers``
(and its plain chain, ``sample_only_kmers_plain``) against the JAX
package's ``breakmer_tpu.ops.kmer.sample_only_kmers`` on the region cases
of ``tools/kmer_time.REGION_CASES`` (seeds made with numpy); the route
plan (``kmer_cuda.region_plan``) and the fused route's refusals before any
launch; and a numpy mirror of the region kernel's algorithm
(``csrc/region_kmers.cu``: its staging in row chunks, a thread's rolling
codes, the radix passes, the bucket index and the membership marks, the
runs by a block scan and the compaction) held to JAX. Exact (tolerance 0: integer outputs).
The kernel itself runs in ``tests/test_torch_cuda.py`` on a card."""

import re
from pathlib import Path

import numpy as np
import pytest

from breakmer_tpu.ops import kmer as jk
from breakmer_tpu_torch.ops import kmer as tk
from breakmer_tpu_torch.ops import kmer_cuda
from breakmer_tpu_torch.tools import kmer_time

SENT = 0xFFFFFFFF
CASES = list(kmer_time.REGION_CASES)
LIMIT = kmer_cuda.H100_SMEM_OPTIN


def _cu_constants():
    """The constants ``csrc/region_kmers.cu`` states, read from the source."""
    text = (Path(kmer_cuda.__file__).resolve().parent.parent / "csrc"
            / "region_kmers.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
            for name in ("THREADS", "BINS", "MISC_WORDS", "MAX_KEYS", "MAX_K", "BUCKETS")}


_CU = _cu_constants()
_WARPS = _CU["THREADS"] // 32


def _jax(args, kw):
    v, c = jk.sample_only_kmers(*args, **kw)
    return np.asarray(v, dtype=np.uint32), np.asarray(c, dtype=np.int32)


def _equal(want, got):
    for a, b in zip(want, got, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _plan(args, kw, limit=LIMIT):
    normal = kw.get("normal_codes")
    return kmer_cuda.region_plan(np.shape(args[0]), len(args[2]),
                                 None if normal is None else normal.shape, args[3], limit)


# -- the port against JAX ------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_sample_only_kmers_matches_jax(name):
    """Every region case: the port's CPU call and its plain chain equal
    JAX's, value for value and count for count, in the same order."""
    args, kw = kmer_time.region_case(name)
    want = _jax(args, kw)
    _equal(want, tk.sample_only_kmers(*args, **kw, device="cpu"))
    _equal(want, tk.sample_only_kmers_plain(*args, **kw))
    if name in ("serial", "no_normal", "k11", "boundary_fits", "boundary_over"):
        assert len(want[0]) > 0


@pytest.mark.parametrize("what", ["reference", "reads", "normal"])
def test_a_set_shorter_than_k_raises_as_in_jax(what, monkeypatch):
    """A reference, reads or normal reads shorter than k: ValueError from
    JAX, from the port on the CPU, and from the fused route before any
    launch (the card's limit given, the launch made to fail if reached)."""
    args, kw = kmer_time.region_case("serial")
    codes, lengths, ref, k = args
    if what == "reference":
        args = (codes, lengths, ref[:k - 1], k)
    elif what == "reads":
        args = (codes[:, :k - 1], lengths, ref, k)
    else:
        kw = dict(kw, normal_codes=kw["normal_codes"][:, :k - 1])
    with pytest.raises(ValueError, match="shorter than k"):
        jk.sample_only_kmers(*args, **kw)
    with pytest.raises(ValueError, match="shorter than k"):
        tk.sample_only_kmers(*args, **kw, device="cpu")
    _no_card(monkeypatch)
    for route in (None, "fused"):
        with pytest.raises(ValueError, match="shorter than k"):
            tk.sample_only_kmers(*args, **kw, device="cuda", route=route)


# -- the route plan -------------------------------------------------------------

def test_plan_bytes_follow_the_kernel_layout():
    """The plan's reckoning of the layout from the source's constants: X
    (the sample's windows + 1 words, or the longest row in 16-byte lines
    with 30 bytes to spare), S, B, the offsets and the counters."""
    assert (kmer_cuda.REGION_WARPS, kmer_cuda.REGION_BINS, kmer_cuda.REGION_MISC_WORDS,
            kmer_cuda.REGION_MAX_KEYS) == (_WARPS, _CU["BINS"], _CU["MISC_WORDS"],
                                           _CU["MAX_KEYS"])
    assert kmer_cuda.MAX_K == _CU["MAX_K"]
    for windows, longest in ((0, 100), (1, 15), (17_200, 1800), (3, 30_000), (26_000, 100)):
        x_lines = max(-(-(windows + 1) // 4), -(-(longest + 30) // 16))
        want = (16 * x_lines + 4 * (-(-windows // 4) * 4 + -(-(-(-windows // 32)) // 4) * 4)
                + 2 * _WARPS * _CU["BINS"] + 4 * _CU["MISC_WORDS"])
        assert kmer_cuda.region_smem_bytes(windows, longest) == want
    # the serial shape: 17,200 windows in 156,416 bytes, a fused launch
    plan = kmer_cuda.region_plan((200, 100), 1800, (160, 102), 15, LIMIT)
    assert plan == kmer_cuda.RegionPlan("fused", 156_416, LIMIT, 17_200)


def test_plan_routes_by_size_alone():
    """The route changes where the layout crosses the card's limit: the
    normal's size and the read contents do not move it; a long reference
    or read row does; past 65,535 windows no limit fuses."""
    fits, over = (kmer_time.region_case(n) for n in ("boundary_fits", "boundary_over"))
    assert _plan(*fits).route == "fused" and _plan(*over).route == "per_function"
    assert _plan(*fits).smem_bytes <= LIMIT < _plan(*over).smem_bytes
    R = fits[0][0].shape[0]
    for normal in (None, (1, 100), (5000, 150)):
        assert kmer_cuda.region_plan((R, 100), 1800, normal, 15, LIMIT).route == "fused"
    assert kmer_cuda.region_plan((R, 100), 200_000, None, 15, LIMIT).route == "per_function"
    assert kmer_cuda.region_plan((1, 300_000), 1800, None, 15, 1 << 30).route == "per_function"
    assert kmer_cuda.region_plan((648, 115), 1800, None, 15, 1 << 30).route == "fused"
    assert kmer_cuda.region_plan((649, 115), 1800, None, 15, 1 << 30).route == "per_function"
    assert kmer_cuda.region_plan((0, 100), 1800, None, 15, LIMIT).route == "fused"


def _no_card(monkeypatch):
    """The card's limit without a card, and every launch and copy to the
    card made to fail if reached."""
    def reached(*a, **kw):
        raise AssertionError("reached the card")

    monkeypatch.setattr(kmer_cuda, "smem_optin", lambda device: LIMIT)
    monkeypatch.setattr(kmer_cuda, "_launch", reached)
    monkeypatch.setattr(kmer_cuda, "_pinned", reached)
    monkeypatch.setattr(tk, "_sample_only_chain", reached)


def test_forced_fused_route_refuses_an_oversized_region_before_any_launch(monkeypatch):
    """route="fused" on a region past the boundary raises ValueError from
    the plan, before anything is staged or launched, and counts no route."""
    _no_card(monkeypatch)
    args, kw = kmer_time.region_case("boundary_over")
    routes = dict(tk.ROUTES)
    with pytest.raises(ValueError, match="shared memory"):
        tk.sample_only_kmers(*args, **kw, device="cuda", route="fused")
    with pytest.raises(ValueError, match="shared memory"):
        kmer_cuda.region_kmers(*args, **kw, device="cuda")
    with pytest.raises(ValueError, match="route"):
        tk.sample_only_kmers(*args, **kw, device="cuda", route="merged")
    assert tk.ROUTES == routes


@pytest.mark.parametrize("name,route", [("boundary_fits", "fused"),
                                        ("boundary_over", "per_function")])
def test_the_plan_picks_the_route_before_anything_reaches_the_card(name, route, monkeypatch):
    """Without a route, the card path asks the plan first: the fused
    route reaches its pinned staging buffer, the per-function one its
    chain."""
    _no_card(monkeypatch)
    reached = []

    def stage(*a, **kw):
        reached.append("fused")
        raise RuntimeError("staged")

    def chain(*a, **kw):
        reached.append("per_function")
        raise RuntimeError("chained")

    monkeypatch.setattr(kmer_cuda, "_pinned", stage)
    monkeypatch.setattr(tk, "_sample_only_chain", chain)
    args, kw = kmer_time.region_case(name)
    with pytest.raises(RuntimeError):
        tk.sample_only_kmers(*args, **kw, device="cuda")
    assert reached == [route]


def test_cpu_calls_take_the_plain_chain_and_launch_nothing(monkeypatch):
    def reached(*a, **kw):
        raise AssertionError("a CPU call reached the card's route")

    monkeypatch.setattr(kmer_cuda, "region_kmers", reached)
    monkeypatch.setattr(kmer_cuda, "_launch", reached)
    before, routes = dict(kmer_cuda.LAUNCHES), dict(tk.ROUTES)
    args, kw = kmer_time.region_case("serial")
    _equal(tk.sample_only_kmers_plain(*args, **kw), tk.sample_only_kmers(*args, **kw,
                                                                          device="cpu"))
    assert kmer_cuda.LAUNCHES == before and tk.ROUTES == routes
    with pytest.raises(ValueError, match="no implementation for device meta"):
        tk.sample_only_kmers(*args, **kw, device="meta")


# -- the packed input -------------------------------------------------------

@pytest.mark.parametrize("name", ["serial", "no_normal", "odd_widths", "empty_sample"])
def test_region_pack_lines(name):
    """Each segment starts on a 16-byte line and takes whole lines, in the
    order the launch reads them; the buffer holds exactly the inputs."""
    args, kw = kmer_time.region_case(name)
    segments, total = kmer_cuda.region_pack(args[0], args[1], args[2],
                                            kw.get("normal_codes"), kw.get("normal_lengths"))
    names = [n for n, _, _ in segments]
    assert names[:4] == ["sample_codes", "sample_lengths", "ref_codes", "ref_length"]
    assert names[4:] == ([] if "normal_codes" not in kw else ["normal_codes", "normal_lengths"])
    ends = [at + -(-a.nbytes // 16) * 16 for _, at, a in segments]
    assert all(at % 16 == 0 for _, at, _ in segments)
    assert [at for _, at, _ in segments[1:]] == ends[:-1] and total == ends[-1]
    buf = _packed(segments, total)
    assert np.array_equal(buf[segments[0][1]:segments[0][1] + args[0].size].view(np.int8),
                          args[0].reshape(-1))
    assert int(buf[segments[3][1]:segments[3][1] + 4].view(np.int32)[0]) == len(args[2])


def _packed(segments, total):
    buf = np.zeros(total, np.uint8)
    for _, at, a in segments:
        buf[at:at + a.nbytes] = a.reshape(-1).view(np.uint8)
    return buf


# -- the kernel's algorithm in numpy ---------------------------------------------

def _match_any(d, active):
    """csrc/region_kmers.cu's ``peers`` for one warp: each lane's mask of
    the lanes whose value matches its own (``__match_any_sync``), an
    inactive lane given 0x100 + lane, a value no digit takes."""
    v = np.where(active, d, 0x100 + np.arange(32))
    return [sum(1 << m for m in range(32) if v[m] == v[lane]) for lane in range(32)]


def _scatter_ranks(d, active):
    """A chunk's ranks as the scatter takes them: the lanes before it in
    its mask, and the count its digit's offset then moves by."""
    masks = _match_any(d, active)
    below = [(1 << lane) - 1 for lane in range(32)]
    return ([bin(m & b).count("1") for m, b in zip(masks, below)],
            [bin(m).count("1") for m in masks])


def test_scatter_ranks_are_stable_ranks_within_a_chunk():
    """The match masks give each active lane its rank among the earlier
    active lanes of its digit, and its digit's count in the chunk;
    inactive lanes match no active one."""
    rng = np.random.default_rng(5)
    for width in (1, 3, 8):
        for _ in range(20):
            d = rng.integers(0, 1 << width, 32)
            active = rng.random(32) < 0.8
            rank, count = _scatter_ranks(d, active)
            for lane in np.flatnonzero(active):
                same = active & (d == d[lane])
                assert rank[lane] == int(same[:lane].sum())
                assert count[lane] == int(same.sum())


def _radix_mirror(keys, bits, warps=_WARPS, bins=_CU["BINS"]):
    """The kernel's ``radix_sort``: 2 or 4 passes of ``ceil(bits /
    passes)`` bits; warp w's keys [w seg, (w + 1) seg) with seg whole
    32-key chunks; a pass counts each warp's digits, scans the counts
    digit-major into uint16 offsets, and scatters a key to its warp's
    offset of its digit plus its rank among the warp's earlier keys of
    that digit (which the chunks' match masks compute, chunk after chunk:
    ``_radix_chunked`` runs that literally)."""
    n = len(keys)
    if bits == 0 or n <= 1:
        return keys.copy()
    passes = 2 if bits <= 16 else 4
    width = -(-bits // passes)
    assert width <= 8
    seg = -(-(-(-n // warps)) // 32) * 32
    warp = np.arange(n) // seg
    src = keys.copy()
    for p in range(passes):
        d = ((src >> np.uint32(p * width)) & np.uint32((1 << width) - 1)).astype(np.int64)
        counts = np.zeros((warps, bins), np.int64)
        np.add.at(counts, (warp, d), 1)
        flat = counts.T.reshape(-1)                              # (digit, warp) order
        offs = (np.cumsum(flat) - flat).reshape(bins, warps).T   # offs[w][d]
        assert offs.max() <= 0xFFFF
        group = warp * bins + d
        order = np.argsort(group, kind="stable")
        first = np.searchsorted(group[order], group[order], side="left")
        rank = np.empty(n, np.int64)
        rank[order] = np.arange(n) - first
        dst = np.empty_like(src)
        dst[offs[warp, d] + rank] = src
        src = dst
    return src


def _windows_mirror(buf, codes_at, lengths_at, R, L, k, stage_lines, threads):
    """``each_window``: the set's rows staged in chunks of
    (16 stage_lines - 30) // L rows; in each chunk thread t takes
    consecutive windows of one row (g = threads // rows threads a row,
    ceil(W / g) windows each; past ``threads`` rows, whole rows t, t +
    threads, ...), computed by the rolling code (k steps at its first
    window, the direct uint32 code where the window holds a negative
    byte). Yields (chunk, round, iteration, thread, code or SENTINEL) in
    the order round, iteration, thread."""
    codes = buf[codes_at:codes_at + R * L].view(np.int8).reshape(R, L)
    lengths = buf[lengths_at:lengths_at + 4 * R].view(np.int32)
    W, mask = L - k + 1, (1 << (2 * k)) - 1
    rows_per = (16 * stage_lines - 30) // L
    assert rows_per >= 1
    for chunk, r0 in enumerate(range(0, R, rows_per)):
        rows = min(R, r0 + rows_per) - r0
        g = threads // rows if rows <= threads else 1
        per = -(-W // g)
        for rnd in range(-(-rows // threads)):
            out = np.full((per, threads), SENT, np.uint64)
            for t in range(threads):
                r = t // g if rows <= threads else rnd * threads + t
                if r >= rows:
                    continue
                w0 = (t % g) * per
                w1 = min(W, w0 + per)
                if w0 >= w1:
                    continue
                row = codes[r0 + r]
                last = (int(lengths[r0 + r]) - k + (1 << 31)) % (1 << 32) - (1 << 31)
                acc, bad_at, neg_at = 0, -1, -1
                for j in range(k):
                    x = int(row[w0 + j])
                    bad_at = w0 + j if x >= 4 else bad_at
                    neg_at = w0 + j if x < 0 else neg_at
                    acc = (acc << 2) | (x & 3)
                for w in range(w0, w1):
                    if w > w0:
                        x = int(row[w + k - 1])
                        bad_at = w + k - 1 if x >= 4 else bad_at
                        neg_at = w + k - 1 if x < 0 else neg_at
                        acc = ((acc << 2) | (x & 3)) & mask
                    if w <= last and bad_at < w:
                        code = acc
                        if neg_at >= w:  # the direct code, as JAX computes it in uint32
                            code = 0
                            for j in range(k):
                                x = int(row[w + j])
                                code = ((code << 2) | (0 if x >= 4 else x & 0xFFFFFFFF)) \
                                    & 0xFFFFFFFF
                        out[w - w0, t] = code
            for i in range(per):
                for t in range(threads):
                    yield chunk, rnd, i, t, int(out[i, t])


def _revcomp(v, k):
    out = 0
    for _ in range(k):
        out = (out << 2) | (3 - (v & 3))
        v >>= 2
    return out


def _region_mirror(segments, total, k, min_count, threads=_CU["THREADS"], least_stage=False):
    """The kernel on the packed buffer, in numpy: (the result buffer, the
    sorted sample codes). ``least_stage``: X's stage as small as the
    longest row allows (the rows staged in many chunks)."""
    buf = _packed(segments, total)
    seg = {name: (at, a) for name, at, a in segments}
    (R, L), L_r = seg["sample_codes"][1].shape, seg["ref_codes"][1].shape[1]
    sets = {"sample": (seg["sample_codes"][0], seg["sample_lengths"][0], R, L),
            "ref": (seg["ref_codes"][0], seg["ref_length"][0], 1, L_r)}
    if "normal_codes" in seg:
        sets["normal"] = (seg["normal_codes"][0], seg["normal_lengths"][0],
                          *seg["normal_codes"][1].shape)
    longest = max(s[3] for s in sets.values())
    n_s = R * (L - k + 1)
    row_lines = -(-(longest + 30) // 16)
    stage_lines = row_lines if least_stage else max(-(-(n_s + 1) // 4), row_lines)
    # 1: appends of valid codes that are not SENTINEL (one schedule of the
    # warps' atomics: iteration, then warp, then lane)
    keys = [code for *_, code in _windows_mirror(buf, *sets["sample"], k, stage_lines,
                                                      threads) if code != SENT]
    s = np.array(keys, np.uint32)
    orv = int(np.bitwise_or.reduce(s)) if len(s) else 0
    # 2: the sort
    s = _radix_mirror(s, orv.bit_length())
    n = len(s)
    # the search index: start[q], the first slot whose top 12 bits are >= q
    shift = max(0, orv.bit_length() - 12)
    start = np.full(_CU["BUCKETS"] + 1, -1, np.int64)
    for i in range(n):
        for q in range(int(s[i - 1] >> shift) + 1 if i else 0, int(s[i] >> shift) + 1):
            start[q] = i
    start[(int(s[n - 1] >> shift) + 1 if n else 0):] = n
    assert (start >= 0).all() and (np.diff(start) >= 0).all()
    # 3: marks at the first slot of each found value, searched in its bucket
    marked = np.zeros(n, bool)

    def mark(v):
        b = v >> shift
        if b >= _CU["BUCKETS"]:
            return
        lo, hi = int(start[b]), int(start[b + 1])
        i = lo + int(np.searchsorted(s[lo:hi], v, side="left"))
        if i < hi and s[i] == v:
            marked[i] = True

    if n:
        for name in ("ref", "normal"):
            if name not in sets:
                continue
            for *_, code in _windows_mirror(buf, *sets[name], k, stage_lines, threads):
                if code != SENT:
                    mark(code)
                    if name == "ref":
                        mark(_revcomp(code, k))
    # 4: run starts by a block scan over consecutive slots a thread
    per = -(-n // threads)
    starts = [i for i in range(n) if i == 0 or s[i] != s[i - 1]]
    counts_a_thread = [sum(1 for i in range(t * per, min(n, t * per + per))
                           if i == 0 or s[i] != s[i - 1]) for t in range(threads)]
    at = np.cumsum([0] + counts_a_thread)[:-1]
    pos = np.empty(len(starts) + 1, np.int64)
    for t in range(threads):
        j = at[t]
        for i in range(t * per, min(n, t * per + per)):
            if i == 0 or s[i] != s[i - 1]:
                pos[j] = i
                j += 1
    runs = len(starts)
    pos[runs] = n
    # 5: the kept runs by a block scan over consecutive runs a thread
    per = -(-runs // threads)
    cap = n_s // max(min_count, 1)
    out = np.zeros(2 + 2 * cap, np.int64)
    keep = [(pos[u + 1] - pos[u]) >= min_count and not marked[pos[u]] for u in range(runs)]
    kept_a_thread = [sum(keep[t * per:min(runs, t * per + per)]) for t in range(threads)]
    at = np.cumsum([0] + kept_a_thread)[:-1]
    for t in range(threads):
        j = at[t]
        for u in range(t * per, min(runs, t * per + per)):
            if keep[u]:
                out[2 + 2 * j], out[3 + 2 * j] = s[pos[u]], pos[u + 1] - pos[u]
                j += 1
    out[0], out[1] = sum(keep), runs
    assert out[0] <= cap
    return out, s


def _mirror_result(out):
    kept = int(out[0])
    pairs = out[2:2 + 2 * kept].reshape(-1, 2)
    v, c = pairs[:, 0].astype(np.uint32), pairs[:, 1].astype(np.int32)
    order = np.lexsort((v, -c.astype(np.int64)))
    return v[order], c[order]


_MIRROR_CASES = [n for n in CASES if n not in ("boundary_fits", "boundary_over")]


@pytest.mark.parametrize("name", _MIRROR_CASES)
def test_region_mirror_matches_jax(name):
    """The kernel's algorithm on the packed buffer, at its own launch
    (1,024 threads, X as the layout sizes it): the sorted codes equal
    np.sort of the valid codes, the kept runs ascend, and, ordered as the
    host orders them, equal JAX's sample_only_kmers."""
    args, kw = kmer_time.region_case(name)
    segments, total = kmer_cuda.region_pack(args[0], args[1], args[2],
                                            kw.get("normal_codes"), kw.get("normal_lengths"))
    out, s = _region_mirror(segments, total, args[3], kw["min_count"])
    codes = jk.kmer_codes_np(args[0], args[1], args[3])[0].reshape(-1) if len(args[0]) else \
        np.zeros(0, np.uint32)
    assert np.array_equal(s, np.sort(codes[codes != SENT]))
    kept = out[2:2 + 2 * int(out[0]):2]
    assert (np.diff(kept) > 0).all()
    _equal(_jax(args, kw), _mirror_result(out))


@pytest.mark.parametrize("name,threads", [
    ("odd_widths", 64), ("serial", 96), ("staged_in_chunks", 32), ("negative_bytes", 128),
    ("short_reads", 64), ("one_run", 33), ("k1", 1024), ("odd_widths", 8), ("serial", 16)])
def test_region_mirror_at_small_tilings(name, threads):
    """The same algorithm at other thread counts and the least stage (a
    set's rows in many chunks; more rows a chunk than threads at 8 and 16
    threads), equal to JAX."""
    args, kw = kmer_time.region_case(name)
    segments, total = kmer_cuda.region_pack(args[0], args[1], args[2],
                                            kw.get("normal_codes"), kw.get("normal_lengths"))
    out, _ = _region_mirror(segments, total, args[3], kw["min_count"], threads=threads,
                            least_stage=True)
    _equal(_jax(args, kw), _mirror_result(out))


def _radix_chunked(keys, bits, warps=_WARPS, bins=_CU["BINS"]):
    """``_radix_mirror`` with the scatter as the kernel runs it: each warp
    walks its keys 32 at a time, a key to its warp's offset of its digit
    plus its rank in the chunk, the offset then moved by the digit's
    count in the chunk."""
    n = len(keys)
    if bits == 0 or n <= 1:
        return keys.copy()
    passes = 2 if bits <= 16 else 4
    width = -(-bits // passes)
    seg = -(-(-(-n // warps)) // 32) * 32
    src = keys.copy()
    for p in range(passes):
        d = ((src >> np.uint32(p * width)) & np.uint32((1 << width) - 1)).astype(np.int64)
        counts = np.zeros((warps, bins), np.int64)
        np.add.at(counts, (np.arange(n) // seg, d), 1)
        flat = counts.T.reshape(-1)
        offs = (np.cumsum(flat) - flat).reshape(bins, warps).T.copy()
        dst = np.empty_like(src)
        for w in range(warps):
            a, b = min(n, w * seg), min(n, w * seg + seg)
            for c in range(a, b, 32):
                lanes = np.arange(c, c + 32)
                active = lanes < b
                dd = np.where(active, d[np.minimum(lanes, n - 1)], 0)
                rank, count = _scatter_ranks(dd, active)
                base = offs[w, dd].copy()
                for lane in np.flatnonzero(active):
                    dst[base[lane] + rank[lane]] = src[c + lane]
                for lane in np.flatnonzero(active):
                    if rank[lane] == 0:
                        offs[w, dd[lane]] = base[lane] + count[lane]
        src = dst
    return src


@pytest.mark.parametrize("bits,n", [(2, 1500), (9, 700), (30, 2000), (32, 333)])
def test_chunked_scatter_equals_the_stable_passes(bits, n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(np.uint32)
    keys[: n // 4] = keys[0]
    want = np.sort(keys)
    assert np.array_equal(_radix_chunked(keys, bits), want)
    assert np.array_equal(_radix_mirror(keys, bits), want)


@pytest.mark.parametrize("bits", [1, 2, 9, 16, 17, 22, 30, 32])
def test_radix_mirror_sorts(bits):
    """The radix passes alone: every width of key, duplicates, n not a
    multiple of 32 warps of 32 keys, a sort of n = 1 and of one value."""
    rng = np.random.default_rng(bits)
    for n in (1, 2, 31, 1000, 17_200):
        keys = rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(np.uint32)
        keys[: n // 3] = keys[0]
        assert np.array_equal(_radix_mirror(keys, bits), np.sort(keys))
