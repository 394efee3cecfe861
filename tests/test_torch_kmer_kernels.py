"""The k-mer engine's CUDA kernels (``breakmer_tpu_torch/csrc/kmer.cu``,
wrappers ``ops/kmer_cuda.py``) without a card: the device dispatch of
``ops/kmer.py``, the wrappers' checks (with the launch made to raise if it
is reached), and numpy mirrors of each kernel's per-element algorithm
against the JAX package's functions (``breakmer_tpu.ops.kmer``) and the
port's plain versions. Exact (tolerance 0: integer outputs). The kernels
themselves run in ``tests/test_torch_cuda.py`` on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from breakmer_tpu.ops import kmer as jk
from breakmer_tpu_torch.ops import kmer as tk
from breakmer_tpu_torch.ops import kmer_cuda

SENT = 0xFFFFFFFF


# -- dispatch ---------------------------------------------------------------

def _calls(device, suffix=""):
    """Each of the four functions (``suffix="_plain"``: its plain version)
    with small inputs on ``device``."""
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 5, (6, 30)).astype(np.int8)).to(device)
    lengths = torch.full((6,), 30, dtype=torch.int32).to(device)
    km = torch.sort(torch.from_numpy(rng.integers(0, 50, 40)).to(device)).values
    counts = torch.ones(40, dtype=torch.int32).to(device)
    fn = {name: getattr(tk, name + suffix) for name in kmer_cuda.KERNELS}
    return {
        "kmer_codes": lambda: fn["kmer_codes"](codes, lengths, 5),
        "revcomp_kmers": lambda: fn["revcomp_kmers"](km, 5),
        "unique_counts_sorted": lambda: fn["unique_counts_sorted"](km),
        "subtract_sorted": lambda: fn["subtract_sorted"](
            km, counts, km[::3].contiguous(), km[1::4].contiguous()),
    }


@pytest.mark.parametrize("name", kmer_cuda.KERNELS)
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


@pytest.mark.parametrize("name", kmer_cuda.KERNELS)
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
    with pytest.raises(ValueError, match="k=0"):
        kmer_cuda.kmer_codes(codes, lengths, 0)
    with pytest.raises(ValueError, match="want"):
        kmer_cuda.kmer_codes(codes, lengths[:2], 5)
    with pytest.raises(ValueError, match="capacity"):
        kmer_cuda.revcomp_kmers(torch.zeros(4, dtype=torch.int64), 16)
    assert wrappers == []


@pytest.mark.parametrize("name,call", [
    ("kmer_codes", lambda: kmer_cuda.kmer_codes(
        torch.zeros((2, 20), dtype=torch.int16), torch.zeros(2, dtype=torch.int32), 5)),
    ("kmer_codes", lambda: kmer_cuda.kmer_codes(
        torch.zeros((2, 20), dtype=torch.int8), torch.zeros(2, dtype=torch.int64), 5)),
    ("revcomp_kmers", lambda: kmer_cuda.revcomp_kmers(torch.zeros(4, dtype=torch.int32), 5)),
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
                                  torch.zeros(0, dtype=torch.int64))
    assert wrappers == ["kmer_codes", "subtract_sorted"]


# -- the kernels' algorithms in numpy ---------------------------------------

def _kmer_codes_mirror(codes: np.ndarray, lengths: np.ndarray, k: int):
    """kmer_codes_kernel per window: a uint64 shift-or of the k codes (a
    code >= 4 adds 0 and invalidates; a negative byte adds its int64
    sign extension), valid iff w <= length - k in wrapping int32."""
    R, L = codes.shape
    W = L - k + 1
    acc = np.zeros((R, W), dtype=np.uint64)
    bad = np.zeros((R, W), dtype=bool)
    for j in range(k):
        x = codes[:, j:j + W].astype(np.int64)
        bad |= x >= 4
        acc = (acc << np.uint64(2)) | np.where(x >= 4, 0, x).astype(np.uint64)
    last = (lengths.astype(np.uint32) - np.uint32(k)).astype(np.int32)
    ok = (np.arange(W)[None, :] <= last[:, None]) & ~bad
    return np.where(ok, acc.astype(np.int64), SENT), ok


def _revcomp_mirror(x: np.ndarray, k: int) -> np.ndarray:
    """revcomp_kmers_kernel per element: k steps of an arithmetic shift."""
    c = x.astype(np.int64)
    o = np.zeros(x.shape, dtype=np.uint64)
    for _ in range(k):
        o = (o << np.uint64(2)) | (3 - (c & 3)).astype(np.uint64)
        c = c >> 2
    return np.where(x == SENT, SENT, o.astype(np.int64))


def _unique_counts_mirror(s: np.ndarray):
    """unique_counts_kernel per element of rows [..., n]: at a run start
    the count is upper_bound(row, v) - i, by the kernel's galloping
    search (probes at i + 1, i + 2, i + 4, ..., then a binary search);
    also returns the loads the searches made."""
    n = s.shape[-1]
    rows = s.reshape(-1, n)
    values = np.full(rows.shape, SENT, dtype=np.int64)
    counts = np.zeros(rows.shape, dtype=np.int32)
    start = np.zeros(rows.shape, dtype=bool)
    loads = 0
    for g, row in enumerate(rows):
        for i in range(n):
            v = row[i]
            if v == SENT or (i > 0 and row[i - 1] == v):
                continue
            lo, hi, step = i, i + 1, 2
            while hi < n and row[hi] == v:
                loads += 1
                lo, hi, step = hi, i + step, step << 1
            loads += hi < n
            hi = min(hi, n)
            while hi - lo > 1:
                mid = lo + (hi - lo) // 2
                loads += 1
                lo, hi = (mid, hi) if row[mid] == v else (lo, mid)
            values[g, i], counts[g, i], start[g, i] = v, hi - i, True
    return (values.reshape(s.shape), counts.reshape(s.shape), start.reshape(s.shape), loads)


def _lower_bound_member(t: np.ndarray, v) -> bool:
    lo, hi = 0, len(t)
    while lo < hi:
        mid = lo + (hi - lo) // 2
        if t[mid] < v:
            lo = mid + 1
        else:
            hi = mid
    return lo < len(t) and t[lo] == v


def _subtract_mirror(values, counts, ref, normal=None):
    """subtract_sorted_kernel per element of rows [..., n] against table
    rows [..., m] (row g against row g)."""
    n = values.shape[-1]
    v2, c2 = values.reshape(-1, n), counts.reshape(-1, n)
    r2 = ref.reshape(len(v2), -1)
    n2 = None if normal is None else normal.reshape(len(v2), -1)
    out_v, out_c = np.full(v2.shape, SENT, dtype=np.int64), np.zeros(v2.shape, dtype=np.int32)
    for g in range(len(v2)):
        for i in range(n):
            v = v2[g, i]
            keep = (v != SENT and not _lower_bound_member(r2[g], v)
                    and not (n2 is not None and _lower_bound_member(n2[g], v)))
            if keep:
                out_v[g, i], out_c[g, i] = v, c2[g, i]
    return out_v.reshape(values.shape), out_c.reshape(values.shape)


def _jax_rows(fn, *rows):
    """A 1-D JAX function applied to each row of [G, N] inputs, restacked."""
    outs = [fn(*(r[g] for r in rows)) for g in range(rows[0].shape[0])]
    outs = [o if isinstance(o, tuple) else (o,) for o in outs]
    return tuple(np.stack([np.asarray(o[j]) for o in outs]) for j in range(len(outs[0])))


def _as_u32(a):
    return np.asarray(a, dtype=np.int64).astype(np.uint32)


@pytest.mark.parametrize("k", [1, 5, 11, 15])
def test_kmer_codes_mirror_matches_jax_and_plain(k):
    rng = np.random.default_rng(k)
    R, L = 24, 40
    codes = rng.integers(0, 4, (R, L)).astype(np.int8)
    codes[rng.random((R, L)) < 0.03] = rng.integers(4, 128, 1)[0]  # N as 4..127
    codes[3, :] = 4  # an all-N row
    lengths = rng.integers(0, L + 20, R).astype(np.int32)  # < k, inside, > L
    lengths[:4] = (0, k - 1, L, L + 7)
    km, ok = _kmer_codes_mirror(codes, lengths, k)
    jkm, jok = jk.kmer_codes(jnp.asarray(codes), jnp.asarray(lengths), k)
    np.testing.assert_array_equal(km.astype(np.uint32), np.asarray(jkm))
    np.testing.assert_array_equal(ok, np.asarray(jok))
    pkm, pok = tk.kmer_codes_plain(torch.from_numpy(codes), torch.from_numpy(lengths), k)
    np.testing.assert_array_equal(km, pkm.numpy())
    np.testing.assert_array_equal(ok, pok.numpy())


def test_kmer_codes_mirror_matches_plain_on_every_byte():
    """Every int8 value, negative ones included (no caller passes one, but
    the kernel keeps the plain version's int64 sign extension)."""
    codes = np.arange(-128, 128, dtype=np.int16).astype(np.int8).reshape(16, 16)
    codes = np.concatenate([codes, np.tile(np.arange(4, dtype=np.int8), (16, 4))], axis=1)
    lengths = np.full(16, 80, dtype=np.int32)
    lengths[0] = np.iinfo(np.int32).min  # wraps below k
    for k in (1, 3, 15):
        km, ok = _kmer_codes_mirror(codes, lengths, k)
        pkm, pok = tk.kmer_codes_plain(torch.from_numpy(codes), torch.from_numpy(lengths), k)
        np.testing.assert_array_equal(km, pkm.numpy())
        np.testing.assert_array_equal(ok, pok.numpy())


@pytest.mark.parametrize("k", [1, 5, 15])
def test_revcomp_mirror_matches_jax_and_plain(k):
    rng = np.random.default_rng(k)
    x = rng.integers(0, 1 << (2 * k), 300).astype(np.int64)
    x[::7] = SENT
    want = np.asarray(jk.revcomp_kmers(jnp.asarray(x.astype(np.uint32)), k))
    np.testing.assert_array_equal(_revcomp_mirror(x, k).astype(np.uint32), want)
    neg = np.concatenate([x, rng.integers(-(1 << 40), 1 << 40, 50)])
    np.testing.assert_array_equal(_revcomp_mirror(neg, k),
                                  tk.revcomp_kmers_plain(torch.from_numpy(neg), k).numpy())


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
    return {
        "all_sentinel": np.full((1, 37), s, dtype=u),
        "one_run_fills_the_row": np.full((1, 1000), 3, dtype=u),
        "run_ends_at_the_row_end": np.array([[0, 4, 7, 7, 7, 7, 7, 7, 7]], dtype=u),
        "run_ends_at_the_first_sentinel": np.array([[5, 5, 5, s, s]], dtype=u),
        "single_element": np.array([[42]], dtype=u),
        "single_sentinel": np.array([[s]], dtype=u),
        "runs_meet_at_row_boundaries": boundary,
        "random_rows": random_rows,
        "runs_of_every_length": np.sort(np.repeat(np.arange(40, dtype=u),
                                                  np.arange(1, 41)))[None, :],
    }


@pytest.mark.parametrize("case", list(_run_rows()))
def test_unique_counts_mirror_matches_jax(case):
    rows = _run_rows()[case]
    v, c, st, _ = _unique_counts_mirror(rows.astype(np.int64))
    want = _jax_rows(jk.unique_counts_sorted, *[jnp.asarray(rows)])
    np.testing.assert_array_equal(_as_u32(v), want[0])
    np.testing.assert_array_equal(c, want[1])
    np.testing.assert_array_equal(st, want[2])
    got = tk.unique_counts_sorted_plain(torch.from_numpy(rows.astype(np.int64)))
    for a, b in zip((v, c, st), got):
        np.testing.assert_array_equal(a, b.numpy())


def test_unique_counts_search_is_logarithmic_in_the_run():
    """A poly-A region: one k-mer filling the row costs about 2 log2(N)
    loads, not N."""
    n = 200 * 86
    _, c, _, loads = _unique_counts_mirror(np.full((1, n), 0, dtype=np.int64))
    assert c[0, 0] == n and int(c.sum()) == n
    assert loads <= 2 * int(np.ceil(np.log2(n))) + 2


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


@pytest.mark.parametrize("G,with_normal", [(1, False), (1, True), (4, True)])
def test_subtract_mirror_matches_jax(G, with_normal):
    rng = np.random.default_rng(G + 2 * with_normal)
    raw = np.sort(rng.integers(0, 60, (G, 80)), axis=1)
    raw[:, 70:] = SENT
    v, c, _, _ = _unique_counts_mirror(raw.astype(np.int64))
    ref = _tables(rng, v, 30, 0.3)
    normal = _tables(rng, v, 17, 0.2) if with_normal else None
    got = _subtract_mirror(v, c, ref, normal)
    want = _jax_rows(jk.subtract_sorted, *[jnp.asarray(a) for a in (
        _as_u32(v), c, _as_u32(ref), *([] if normal is None else [_as_u32(normal)]))])
    np.testing.assert_array_equal(_as_u32(got[0]), want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert 0 < int((got[0] != SENT).sum()) < int((v != SENT).sum())
    plain = tk.subtract_sorted_plain(*(torch.from_numpy(a) for a in (v, c, ref)),
                                      None if normal is None else torch.from_numpy(normal))
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b.numpy())


def test_subtract_mirror_on_sentinel_and_empty_tables():
    """All-SENTINEL tables subtract nothing (against JAX); a table of width
    0 finds nothing (JAX and the plain version index past its end, so the
    mirror is held to numpy's set difference)."""
    rng = np.random.default_rng(5)
    raw = np.sort(rng.integers(0, 30, (2, 40)), axis=1)
    raw[1, 25:] = SENT
    v, c, _, _ = _unique_counts_mirror(raw.astype(np.int64))
    sent_table = np.full((2, 9), SENT, dtype=np.int64)
    got = _subtract_mirror(v, c, sent_table, sent_table)
    want = _jax_rows(jk.subtract_sorted, jnp.asarray(_as_u32(v)), jnp.asarray(c),
                     jnp.asarray(_as_u32(sent_table)), jnp.asarray(_as_u32(sent_table)))
    np.testing.assert_array_equal(_as_u32(got[0]), want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], v)
    empty = np.zeros((2, 0), dtype=np.int64)
    ref = np.sort(np.stack([rng.choice(30, 8, replace=False) for _ in v]), axis=1)
    for normal in (None, empty):
        out_v, out_c = _subtract_mirror(v, c, ref, normal)
        keep = (v != SENT) & ~np.stack([np.isin(v[g], ref[g]) for g in range(2)])
        np.testing.assert_array_equal(out_v, np.where(keep, v, SENT))
        np.testing.assert_array_equal(out_c, np.where(keep, c, 0))
    out_v, out_c = _subtract_mirror(v, c, empty, empty)
    np.testing.assert_array_equal(out_v, v)
    np.testing.assert_array_equal(out_c, c)
