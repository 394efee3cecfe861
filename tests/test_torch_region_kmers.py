"""A serial region's k-mer call on the CPU: the port's ``sample_only_kmers``
(and its plain chain, ``sample_only_kmers_plain``) against the JAX
package's ``breakmer_tpu.ops.kmer.sample_only_kmers`` on the region cases
of ``tools/kmer_time.REGION_CASES`` (seeds made with numpy); the route
plan (``kmer_cuda.region_plan``: the route and the cluster size from the
shapes and the card's limits) and the fused route's refusals before any
launch; and a numpy mirror of the region kernel's algorithm
(``csrc/region_kmers.cu``) at a cluster of C CTAs: each CTA's rows, its
staging in row chunks, a thread's rolling codes, the rank-partitioned
radix passes over the cluster, each CTA's bucket index and the
membership marks in the CTA holding a value's first slot, the runs by a
block scan with runs across CTA boundaries, and the compaction over the
cluster, held to JAX at C = 1, 2, 4 and 8. Exact (tolerance 0: integer
outputs). The kernel itself runs in ``tests/test_torch_cuda.py`` on a
card."""

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
            for name in ("THREADS", "BINS", "MISC_WORDS", "MAX_KEYS", "MAX_K", "BUCKETS",
                         "MAX_CLUSTER", "HEADER")}


_CU = _cu_constants()
_WARPS = _CU["THREADS"] // 32


def _jax(args, kw):
    v, c = jk.sample_only_kmers(*args, **kw)
    return np.asarray(v, dtype=np.uint32), np.asarray(c, dtype=np.int32)


def _equal(want, got):
    for a, b in zip(want, got, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _plan(args, kw, limit=LIMIT, **opts):
    normal = kw.get("normal_codes")
    return kmer_cuda.region_plan(np.shape(args[0]), len(args[2]),
                                 None if normal is None else normal.shape, args[3], limit,
                                 **opts)


# -- the port against JAX ------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_sample_only_kmers_matches_jax(name):
    """Every region case: the port's CPU call and its plain chain equal
    JAX's, value for value and count for count, in the same order."""
    args, kw = kmer_time.region_case(name)
    want = _jax(args, kw)
    _equal(want, tk.sample_only_kmers(*args, **kw, device="cpu"))
    _equal(want, tk.sample_only_kmers_plain(*args, **kw))
    if name in ("serial", "no_normal", "k11", "boundary_fits", "boundary_over", "deep_250",
                "past_old_limit", "mostly_poly_a", "tandem"):
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

def _layout_bytes(R, W, longest, C):
    """region_layout(R, W, longest, C).bytes of the source, restated."""
    rows, share = -(-R // C), -(-(R * W) // C)
    x_lines = max(-(-(rows * W + 1) // 4), -(-(longest + 30) // 16))
    return (16 * x_lines + 4 * (-(-(rows * W) // 4) * 4 + -(-(-(-share // 32)) // 4) * 4)
            + 2 * _WARPS * _CU["BINS"] + 4 * (_CU["MISC_WORDS"] + _CU["BINS"] * C))


def test_plan_bytes_follow_the_kernel_layout():
    """The plan's reckoning of a CTA's layout from the source's constants,
    at every cluster size: X (a CTA's rows' windows + 1 words, or the
    longest row in 16-byte lines with 30 bytes to spare), S (the windows
    of a CTA's rows), B (a bit a slot of its share), the offsets, the
    counters and tables, and 256 digit totals a CTA of the cluster."""
    assert (kmer_cuda.REGION_WARPS, kmer_cuda.REGION_BINS, kmer_cuda.REGION_MISC_WORDS,
            kmer_cuda.REGION_MAX_KEYS) == (_WARPS, _CU["BINS"], _CU["MISC_WORDS"],
                                           _CU["MAX_KEYS"])
    assert kmer_cuda.MAX_K == _CU["MAX_K"]
    assert max(kmer_cuda.REGION_CLUSTERS) == _CU["MAX_CLUSTER"]
    for C in kmer_cuda.REGION_CLUSTERS:
        for R, W, longest in ((0, 86, 100), (1, 1, 15), (200, 86, 1800), (3, 1, 30_000),
                              (309, 86, 100), (1232, 86, 1800), (340, 236, 1800), (7, 23, 37)):
            assert kmer_cuda.region_smem_bytes(R, W, longest, C) == _layout_bytes(R, W, longest,
                                                                                  C)
    # the serial shape: 17,200 windows; one block needs 159,872 bytes, a CTA
    # of 16 44,560
    assert kmer_cuda.region_smem_bytes(200, 86, 1800) == 159_872
    plan = kmer_cuda.region_plan((200, 100), 1800, (160, 102), 15, LIMIT)
    assert plan == kmer_cuda.RegionPlan("fused", 44_560, LIMIT, 17_200, 16)


def test_plan_routes_by_size_alone():
    """The route changes where the layout crosses the card's limit at its
    largest cluster: the normal's size and the read contents do not move
    it; a long reference or read row does; past 65,535 windows a CTA no
    limit fuses."""
    fits, over = (kmer_time.region_case(n) for n in ("boundary_fits", "boundary_over"))
    assert _plan(*fits).route == "fused" and _plan(*over).route == "per_function"
    assert _plan(*fits).smem_bytes <= LIMIT < _plan(*over).smem_bytes
    assert _plan(*fits).cluster == max(kmer_cuda.H100_CLUSTERS)
    R = fits[0][0].shape[0]
    for normal in (None, (1, 100), (5000, 150)):
        assert kmer_cuda.region_plan((R, 100), 1800, normal, 15, LIMIT).route == "fused"
    assert kmer_cuda.region_plan((R, 100), 200_000, None, 15, LIMIT).route == "per_function"
    assert kmer_cuda.region_plan((1, 300_000), 1800, None, 15, 1 << 30).route == "per_function"
    for C, most in ((1, 648), (8, 8 * 648), (16, 16 * 648)):
        assert kmer_cuda.region_plan((most, 115), 1800, None, 15, 1 << 30,
                                     (C,)).route == "fused"
        assert kmer_cuda.region_plan((most + 1, 115), 1800, None, 15, 1 << 30,
                                     (C,)).route == "per_function"
    assert kmer_cuda.region_plan((0, 100), 1800, None, 15, LIMIT).route == "fused"


@pytest.mark.parametrize("ref_len,normal,k", [(1800, (160, 102), 15), (15, None, 15),
                                               (1001, (13, 29), 11), (30_000, (5000, 150), 1),
                                               (1800, (0, 100), 15)])
def test_scratch_words_follow_the_kernel(ref_len, normal, k):
    """The global scratch a cluster's launch needs, restated from the
    source's region_scratch: a CTA's header, its share of the reference's
    windows and of the normal's rows' windows (in 16-byte lines), and the
    bins that take those codes and the reference codes' reverse
    complements; none for one block."""
    R_n, L_n = normal or (0, 0)
    for C in kmer_cuda.REGION_CLUSTERS:
        ref_cap = -(-(-(-(ref_len - k + 1) // C)) // 4) * 4
        norm_cap = -(-(-(-R_n // C) * (L_n - k + 1 if R_n else 0)) // 4) * 4
        want = 0 if C == 1 else C * (_CU["HEADER"] + ref_cap + norm_cap + 2 * ref_cap + norm_cap)
        assert kmer_cuda.region_scratch_words(ref_len, normal, k, C) == want
    assert _CU["HEADER"] >= 4 + _CU["MAX_CLUSTER"] + 1  # counts, then C + 1 bin starts


def _want_cluster(R, clusters):
    """The plan's rule, restated for 100-base reads at k = 15 against a
    reference of 1,800: the smallest size the card runs, at least the
    table's (or the card's largest), whose layout fits; 0: none."""
    least = min(kmer_cuda.region_cluster(R * 86), max(clusters))
    return min([c for c in clusters if c >= least and _layout_bytes(R, 86, 1800, c) <= LIMIT
                and -(-R // c) * 86 <= _CU["MAX_KEYS"]], default=0)


@pytest.mark.parametrize("normal", [None, (160, 102)])
def test_plan_picks_the_cluster_from_the_shapes(normal):
    """The cluster size: C = 1 below ``CLUSTER_BY_WINDOWS``'s first step,
    then the table's size, else the smallest larger one whose layout fits;
    never one the card does not run; and the fused route for every sample
    of up to 1,232 reads of 100 bases, with or without a normal, at four
    times the first design's 308."""
    plan = kmer_cuda.region_plan
    step, size = kmer_cuda.CLUSTER_BY_WINDOWS[1]
    assert plan((step // 86, 100), 1800, normal, 15, LIMIT).cluster == 1
    assert plan((-(-step // 86), 100), 1800, normal, 15, LIMIT).cluster == size
    assert plan((200, 100), 1800, normal, 15, LIMIT).cluster == 16
    for clusters in (kmer_cuda.H100_CLUSTERS, (1, 2, 4, 8), (1, 2, 4), (1,)):
        for R in (1, 20, 47, 200, 303, 304, 308, 309, 600, 1232, 2344, 2345, 4496, 4497):
            p = plan((R, 100), 1800, normal, 15, LIMIT, clusters)
            assert p.cluster == _want_cluster(R, clusters), (clusters, R)
            assert (p.route == "fused") == (p.cluster > 0) and p.cluster in (0, *clusters)
    for R in range(1, 1233):
        assert plan((R, 100), 1800, normal, 15, LIMIT).route == "fused"
    assert plan((1232, 100), 1800, normal, 15, LIMIT, (1, 2, 4)).route == "per_function"
    # forcing a size: that size alone
    assert plan((200, 100), 1800, normal, 15, LIMIT, cluster=2).cluster == 2
    assert plan((600, 100), 1800, normal, 15, LIMIT, cluster=1).route == "per_function"
    assert plan((200, 100), 1800, normal, 15, LIMIT, (1, 2, 4), cluster=8).route == \
        "per_function"


def _no_card(monkeypatch):
    """The card's limit without a card, and every launch and copy to the
    card made to fail if reached."""
    def reached(*a, **kw):
        raise AssertionError("reached the card")

    monkeypatch.setattr(kmer_cuda, "smem_optin", lambda device: LIMIT)
    monkeypatch.setattr(kmer_cuda, "cluster_sizes", lambda device: kmer_cuda.H100_CLUSTERS)
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


def test_checks_and_plan_run_once_a_call(monkeypatch):
    """A card call of sample_only_kmers checks its inputs and plans its
    route once, and hands the plan to the fused route; a forced route
    plans once too."""
    _no_card(monkeypatch)
    made = {"check_region": 0, "region_plan": 0}

    def counted(name):
        fn = getattr(kmer_cuda, name)

        def wrapped(*a, **kw):
            made[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name in made:
        monkeypatch.setattr(kmer_cuda, name, counted(name))

    def stage(*a, **kw):
        raise RuntimeError("staged")

    monkeypatch.setattr(kmer_cuda, "_pinned", stage)
    args, kw = kmer_time.region_case("serial")
    for route in (None, "fused"):
        made.update(check_region=0, region_plan=0)
        with pytest.raises(RuntimeError, match="staged"):
            tk.sample_only_kmers(*args, **kw, device="cuda", route=route)
        assert made == {"check_region": 1, "region_plan": 1}, route


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


def _radix_cluster(parts, bits, share, warps=_WARPS, bins=_CU["BINS"]):
    """The kernel's ``radix_sort`` over a cluster of ``len(parts)`` CTAs,
    CTA r starting with the keys ``parts[r]`` (its appended codes): 2 or
    4 passes of ``ceil(bits / passes)`` bits at C = 1; with C > 1
    ceil(bits / 8) passes, at least one (of digit 0 where no bit sorts;
    the kernel scatters a CTA's keys by digit locally, then copies each
    digit's run to its ranks, the same ranks); in a pass each CTA splits its keys over
    its warps (warp w's keys [w seg, (w + 1) seg), seg whole 32-key
    chunks), counts each warp's digits, takes each warp's offset within
    the CTA's digit (uint16) and the CTA's digit totals; a digit's base
    is the cluster's keys of lower digits and the digit's keys in the
    CTAs before; a key goes to rank base + its warp's offset + its rank
    among the warp's earlier keys of its digit (which the chunks' match
    masks compute, chunk after chunk: ``_radix_chunked`` runs that
    literally), into CTA rank // share. Returns each CTA's ranks
    [r share, (r + 1) share)."""
    C, n = len(parts), sum(len(p) for p in parts)
    passes = 0 if bits == 0 or n <= 1 else -(-bits // 8) if C > 1 else (2 if bits <= 16 else 4)
    width = -(-bits // passes) if passes else 0
    if C > 1 and passes == 0:
        passes = 1
    assert width <= 8
    src = [p.copy() for p in parts]
    for p in range(passes):
        digits, within, totals = [], [], []
        for keys in src:
            cnt = len(keys)
            assert cnt <= _CU["MAX_KEYS"]
            seg = -(-(-(-cnt // warps)) // 32) * 32
            warp = np.arange(cnt) // max(seg, 1)
            d = ((keys >> np.uint32(p * width)) & np.uint32((1 << width) - 1)).astype(np.int64)
            counts = np.zeros((warps, bins), np.int64)
            np.add.at(counts, (warp, d), 1)
            offs = np.cumsum(counts, 0) - counts    # offs[w][d], within the CTA's digit
            assert offs.max(initial=0) <= 0xFFFF
            digits.append((warp, d))
            within.append(offs)
            totals.append(counts.sum(0))
        tot = np.sum(totals, 0)
        start = np.cumsum(tot) - tot
        dst = np.empty(n, np.uint32)
        for r, keys in enumerate(src):
            warp, d = digits[r]
            base = start + np.sum(totals[:r], 0) if r else start
            group = warp * bins + d
            order = np.argsort(group, kind="stable")
            first = np.searchsorted(group[order], group[order], side="left")
            rank = np.empty(len(keys), np.int64)
            rank[order] = np.arange(len(keys)) - first
            dst[base[d] + within[r][warp, d] + rank] = keys
        src = [dst[min(n, c * share):min(n, (c + 1) * share)] for c in range(C)]
    return src


def _radix_mirror(keys, bits, cluster=1):
    """``_radix_cluster`` of ``keys`` appended by ``cluster`` CTAs in
    uneven parts, the sorted ranks joined."""
    n, C = len(keys), cluster
    cuts = [0, *sorted(np.random.default_rng(n + C).integers(0, n + 1, C - 1)), n]
    parts = [keys[cuts[r]:cuts[r + 1]] for r in range(C)]
    return np.concatenate(_radix_cluster(parts, bits, -(-n // C)))


def _windows_mirror(buf, codes_at, lengths_at, R, L, k, stage_lines, threads, skip=0):
    """``each_window``: the set's rows staged in chunks of
    (16 stage_lines - 30) // L rows; in each chunk thread t takes
    consecutive windows of one row (g = threads // rows threads a row,
    ceil(W / g) windows each; past ``threads`` rows, whole rows t, t +
    threads, ...), computed by the rolling code (k steps at its first
    window, the direct uint32 code where the window holds a negative
    byte); ``skip``: the windows of the row before ``codes_at`` (a CTA's
    part of the reference's row: w <= length - skip - k). At k <= 0 a
    window holds no base: every row in one chunk, no byte read, code 0
    where w <= length - skip - k (W = L - k + 1; in a part of the
    reference L may be below 0). Yields (chunk, round, iteration, thread,
    code or SENTINEL) in the order round, iteration, thread."""
    lengths = buf[lengths_at:lengths_at + 4 * R].view(np.int32)
    W = L - k + 1
    if k > 0:
        codes = buf[codes_at:codes_at + R * L].view(np.int8).reshape(R, L)
        mask, rows_per = (1 << (2 * k)) - 1, (16 * stage_lines - 30) // L
    else:
        codes, mask, rows_per = None, 0, R
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
                row = codes[r0 + r] if k > 0 else None
                last = (int(lengths[r0 + r]) - skip - k + (1 << 31)) % (1 << 32) - (1 << 31)
                acc, bad_at, neg_at = 0, -1, -1
                for j in range(k):
                    x = int(row[w0 + j])
                    bad_at = w0 + j if x >= 4 else bad_at
                    neg_at = w0 + j if x < 0 else neg_at
                    acc = (acc << 2) | (x & 3)
                for w in range(w0, w1):
                    if w > w0 and k > 0:
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


def _placed(flags, threads):
    """A block scan's placement of the flagged slots: thread t takes slots
    [t per, (t + 1) per), counts its flags, and writes its flagged slots
    from its exclusive prefix on; returns the slots in their places."""
    m = len(flags)
    per = -(-m // threads)
    counts = [int(np.sum(flags[t * per:min(m, t * per + per)])) for t in range(threads)]
    at = np.cumsum([0] + counts)[:-1]
    placed = np.full(int(np.sum(counts)), -1, np.int64)
    for t in range(threads):
        j = at[t]
        for i in range(t * per, min(m, t * per + per)):
            if flags[i]:
                placed[j] = i
                j += 1
    assert (placed >= 0).all()
    return placed


def _bucket_index(s, shift):
    """A CTA's search index: start[q], its first slot whose top 12 bits
    are >= q; start[BUCKETS] = its slots."""
    n = len(s)
    start = np.full(_CU["BUCKETS"] + 1, -1, np.int64)
    for i in range(n):
        for q in range(int(s[i - 1] >> shift) + 1 if i else 0, int(s[i] >> shift) + 1):
            start[q] = i
    start[(int(s[n - 1] >> shift) + 1 if n else 0):] = n
    assert (start >= 0).all() and (np.diff(start) >= 0).all()
    return start


def _region_mirror(segments, total, k, min_count, threads=_CU["THREADS"], least_stage=False,
                   cluster=1):
    """The kernel on the packed buffer, in numpy, at a cluster of
    ``cluster`` CTAs: (the result buffer, each CTA's sorted codes).
    ``least_stage``: X's stage as small as the longest row allows (the
    rows staged in many chunks)."""
    C = cluster
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
    stage_lines = row_lines if least_stage else max(-(-(-(-R // C) * (L - k + 1) + 1) // 4),
                                                    row_lines)

    def rows_part(name, r):  # CTA r's rows: (codes at, lengths at, rows, width, skip)
        at, lengths_at, rows, width = sets[name]
        r0, r1 = rows * r // C, rows * (r + 1) // C
        return at + r0 * width, lengths_at + 4 * r0, r1 - r0, width, 0

    def windows_part(name, r):  # CTA r's windows of a one-row set
        at, lengths_at, _, width = sets[name]
        w = width - k + 1
        w0, w1 = w * r // C, w * (r + 1) // C
        return at + (w0 if k > 0 else 0), lengths_at, int(w1 > w0), w1 - w0 + k - 1, w0

    def codes(part):
        return [code for *_, code in _windows_mirror(buf, *part[:4], k, stage_lines, threads,
                                                     skip=part[4]) if code != SENT]

    # 1: each CTA's appends of valid codes that are not SENTINEL (one
    # schedule of the warps' atomics: iteration, then warp, then lane)
    appended = [np.array(codes(rows_part("sample", r)), np.uint32) for r in range(C)]
    n = sum(len(a) for a in appended)
    orv = int(np.bitwise_or.reduce(np.concatenate(appended))) if n else 0
    share = -(-n // C)
    # 2: the sort, partitioned by rank
    parts = _radix_cluster(appended, orv.bit_length(), share)
    assert [len(p) for p in parts] == [max(0, min(share, n - c * share)) for c in range(C)]
    # each CTA's index, first and last value, and slots equal to its first
    shift = max(0, orv.bit_length() - 12)
    index = [_bucket_index(p, shift) for p in parts]
    filled = -(-n // share) if n else 0
    first = [int(p[0]) if len(p) else 0 for p in parts]
    last = [int(p[-1]) if len(p) else 0 for p in parts]
    lead = [int(np.sum(p == p[0])) if len(p) else 0 for p in parts]
    # 3: the reference's (both strands) and the normal's codes (C > 1: CTA
    # r's share of the reference's windows and of the normal's rows,
    # computed with the sample's codes into its scratch, then binned by the
    # CTA that owns each value, which searches its bins), marked where
    # owned: a found value's first slot, in the lowest CTA whose [first,
    # last] holds it, searched in its bucket
    marked = [np.zeros(len(p), bool) for p in parts]

    def mark(v):
        b = v >> shift
        if b >= _CU["BUCKETS"]:
            return
        c = sum(1 for j in range(filled) if last[j] < v)
        if c == filled or first[c] > v:
            return
        s, start = parts[c], index[c]
        lo, hi = int(start[b]), int(start[b + 1])
        i = lo + int(np.searchsorted(s[lo:hi], v, side="left"))
        if i < hi and s[i] == v:
            marked[c][i] = True

    ref_cap = -(-(-(-(L_r - k + 1) // C)) // 4) * 4  # a CTA's scratch for its shares
    norm_cap = (-(-(-(-sets["normal"][2] // C) * (sets["normal"][3] - k + 1)) // 4) * 4
                if "normal" in sets else 0)
    for r in range(C):
        ref_codes = codes(windows_part("ref", r))
        normal_codes = codes(rows_part("normal", r)) if "normal" in sets else []
        assert len(ref_codes) <= ref_cap and len(normal_codes) <= norm_cap or C == 1
        for code in ref_codes if n else []:
            mark(code)
            mark(_revcomp(code, k))
        for code in normal_codes if n else []:
            mark(code)
    # 4-5: each CTA's run starts and kept runs by block scans; a CTA's
    # last run counts the following CTAs' leading slots of its value; the
    # CTAs' kept pairs placed by a scan over the cluster
    cap = n_s // max(min_count, 1)
    out = np.zeros(2 + 2 * cap, np.int64)
    base = all_runs = 0
    for r, s in enumerate(parts):
        m = len(s)
        starts = np.ones(m, bool)
        starts[1:] = s[1:] != s[:-1]
        if m and r:
            starts[0] = s[0] != last[r - 1]
        pos = np.append(_placed(starts, threads), m)
        runs = len(pos) - 1
        tail = 0
        for c in range(r + 1, filled):
            if not m or first[c] != s[-1]:
                break
            tail += lead[c]
            if lead[c] < len(parts[c]):
                break
        count = np.diff(pos) + (np.arange(runs) == runs - 1) * tail
        keep = (count >= min_count) & ~marked[r][pos[:-1]]
        for j, u in enumerate(_placed(keep, threads)):
            out[2 + 2 * (base + j)], out[3 + 2 * (base + j)] = s[pos[u]], count[u]
        base += int(keep.sum())
        all_runs += runs
    out[0], out[1] = base, all_runs
    assert out[0] <= cap
    return out, parts


def _mirror_result(out):
    kept = int(out[0])
    pairs = out[2:2 + 2 * kept].reshape(-1, 2)
    v, c = pairs[:, 0].astype(np.uint32), pairs[:, 1].astype(np.int32)
    order = np.lexsort((v, -c.astype(np.int64)))
    return v[order], c[order]


def _takes(name, C):
    """Whether a CTA of a cluster of C takes the case's sample: its rows'
    windows below 65,536 (the uint16 offsets)."""
    args, _ = kmer_time.region_case(name)
    (R, L), k = np.shape(args[0]), args[3]
    return -(-R // C) * max(0, L - k + 1) <= _CU["MAX_KEYS"]


_MIRROR_CASES = [n for n in CASES if n not in ("boundary_fits", "boundary_over")
                 and _takes(n, 1)]
_NEW_CASES = ("old_limit_fits", "old_limit_over", "past_old_limit", "deep_250",
              "mostly_poly_a", "tandem")
_CLUSTER_CASES = [(n, C) for C in (2, 4, 8)
                  for n in CASES if n not in ("boundary_fits", "boundary_over")]


def _mirror_checked(name, cluster, min_count=None, **opts):
    """The mirror on a case at a cluster size, held to JAX: the CTAs'
    sorted codes joined equal np.sort of the valid codes, the kept runs
    ascend, and, ordered as the host orders them, equal JAX's
    sample_only_kmers. Returns each CTA's sorted codes."""
    args, kw = kmer_time.region_case(name)
    if min_count is not None:
        kw = dict(kw, min_count=min_count)
    segments, total = kmer_cuda.region_pack(args[0], args[1], args[2],
                                            kw.get("normal_codes"), kw.get("normal_lengths"))
    out, parts = _region_mirror(segments, total, args[3], kw["min_count"], cluster=cluster,
                                **opts)
    codes = jk.kmer_codes_np(args[0], args[1], args[3])[0].reshape(-1) if len(args[0]) else \
        np.zeros(0, np.uint32)
    assert np.array_equal(np.concatenate(parts), np.sort(codes[codes != SENT]))
    kept = out[2:2 + 2 * int(out[0]):2]
    assert (np.diff(kept) > 0).all()
    _equal(_jax(args, kw), _mirror_result(out))
    return parts


@pytest.mark.parametrize("name", _MIRROR_CASES)
def test_region_mirror_matches_jax(name):
    """The kernel's algorithm on the packed buffer, at its launch of one
    block (1,024 threads, X as the layout sizes it), equal to JAX."""
    _mirror_checked(name, 1)


@pytest.mark.parametrize("name,cluster", _CLUSTER_CASES + [
    (n, 1) for n in _NEW_CASES if _takes(n, 1)])
def test_cluster_mirror_matches_jax(name, cluster):
    """The same at a cluster of 2, 4 and 8 CTAs on every region case but
    the plan's edge (the new cases at one block too): the rank-partitioned
    sort, each CTA's index, the marks in the CTA that owns a value (each
    CTA computing its share of the reference's and normal's codes), runs
    across CTA boundaries and the kept pairs placed over the cluster,
    equal to JAX."""
    _mirror_checked(name, cluster)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("min_count", [1, 2])
@pytest.mark.parametrize("name", ["mostly_poly_a", "tandem", "poly_a", "one_run"])
def test_cluster_mirror_on_one_heavy_value(name, min_count, cluster):
    """Regions where one value (or two) holds most windows, at min_count 1
    and 2: a run that spans CTAs (at 8 CTAs, in the mostly poly-A region,
    every CTA), counted once by the CTA of its first slot, equal to JAX."""
    parts = _mirror_checked(name, cluster, min_count)
    top = np.concatenate(parts)
    values, counts = np.unique(top, return_counts=True)
    heavy = values[np.argmax(counts)]
    spans = sum(1 for p in parts if len(p) and p[0] <= heavy <= p[-1])
    assert spans >= (cluster if name in ("mostly_poly_a", "poly_a") else 1)


@pytest.mark.parametrize("name,threads", [
    ("odd_widths", 64), ("serial", 96), ("staged_in_chunks", 32), ("negative_bytes", 128),
    ("short_reads", 64), ("one_run", 33), ("k1", 1024), ("odd_widths", 8), ("serial", 16)])
def test_region_mirror_at_small_tilings(name, threads):
    """The same algorithm at other thread counts and the least stage (a
    set's rows in many chunks; more rows a chunk than threads at 8 and 16
    threads), equal to JAX."""
    _mirror_checked(name, 1, threads=threads, least_stage=True)


@pytest.mark.parametrize("name,threads,cluster", [
    ("odd_widths", 64, 4), ("serial", 96, 2), ("staged_in_chunks", 32, 8),
    ("negative_bytes", 128, 4), ("mostly_poly_a", 64, 8), ("tandem", 33, 2),
    ("long_ref", 16, 8), ("normal_of_short_reads", 8, 4)])
def test_cluster_mirror_at_small_tilings(name, threads, cluster):
    """A cluster at other thread counts and the least stage, equal to
    JAX."""
    _mirror_checked(name, cluster, threads=threads, least_stage=True)


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


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
@pytest.mark.parametrize("bits", [0, 1, 9, 17, 30])
def test_cluster_radix_sorts(bits, cluster):
    """The cluster's passes: keys appended in uneven parts (some CTAs
    none) end sorted and partitioned by rank, ceil(n / C) a CTA, whatever
    the values: one value everywhere (0 bits: passes of digit 0 alone), n
    below C, a value on most keys."""
    rng = np.random.default_rng(bits + 100 * cluster)
    for n in (0, 1, 3, 31, 1000, 17_200):
        keys = rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(np.uint32)
        keys[: 3 * n // 4] = keys[0] if n else 0
        assert np.array_equal(_radix_mirror(keys, bits, cluster), np.sort(keys))
