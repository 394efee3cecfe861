"""The port's k-mer engine (breakmer_tpu_torch.ops.kmer) against the JAX
package's (breakmer_tpu.ops.kmer) on seeded numpy inputs: every function,
with N bases, short reads, a matched normal and an empty result. Exact
(tolerance 0). On the device the port carries codes as int64; the host
wrappers return the reference's dtypes, which the tests pin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from breakmer_tpu.ops import kmer as jk
from breakmer_tpu_torch.ops import kmer as tk

K = 15


def _reads(seed, R=40, L=60, n_rate=0.01, short=True):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (R, L)).astype(np.int8)
    codes[rng.random((R, L)) < n_rate] = 4
    lengths = np.full(R, L, dtype=np.int32)
    if short:
        lengths[::5] = rng.integers(5, L, len(lengths[::5]))  # some shorter than k
        for r in range(R):
            codes[r, lengths[r]:] = 4
    return codes, lengths


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(ref, got):
    """JAX uint32 device array vs the port's int64 carry (or equal dtypes)."""
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if ref.dtype == np.uint32:
        assert got.dtype == np.int64
        got = got.astype(np.uint32)
    else:
        assert ref.dtype == got.dtype, (ref.dtype, got.dtype)
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("k", [5, 11, 15])
def test_kmer_codes_and_revcomp(k):
    codes, lengths = _reads(1)
    ref_km, ref_valid = jk.kmer_codes(jnp.asarray(codes), jnp.asarray(lengths), k)
    km, valid = tk.kmer_codes(_t(codes), _t(lengths), k)
    _same(ref_km, km)
    _same(ref_valid, valid)
    _same(jk.revcomp_kmers(ref_km, k), tk.revcomp_kmers(km, k))


def test_kmer_codes_rejects_what_the_reference_rejects():
    codes, lengths = _reads(2, L=10)
    with pytest.raises(ValueError, match="shorter"):
        tk.kmer_codes(_t(codes), _t(lengths), 11)
    with pytest.raises(ValueError, match="capacity"):
        tk.kmer_codes(_t(codes), _t(lengths), 16)


def test_sort_count_member_subtract():
    codes, lengths = _reads(3, R=60, L=50)
    # duplicate reads so counts > 1 exist
    codes = np.concatenate([codes, codes[:20]])
    lengths = np.concatenate([lengths, lengths[:20]])
    ref_km, _ = jk.kmer_codes(jnp.asarray(codes), jnp.asarray(lengths), K)
    km, _ = tk.kmer_codes(_t(codes), _t(lengths), K)
    ref_sorted, srt = jk.sort_kmers(ref_km), tk.sort_kmers(km)
    _same(ref_sorted, srt)
    for a, b in zip(jk.unique_counts_sorted(ref_sorted), tk.unique_counts_sorted(srt)):
        _same(a, b)
    table_codes, table_len = _reads(4, R=10, L=50, short=False)
    ref_table = jk.sort_kmers(jk.kmer_codes(jnp.asarray(table_codes), jnp.asarray(table_len), K)[0])
    table = tk.sort_kmers(tk.kmer_codes(_t(table_codes), _t(table_len), K)[0])
    # make half of the sample's k-mers members of the table
    ref_table = jnp.sort(jnp.concatenate([ref_table, ref_sorted[::2]]))
    table = torch.sort(torch.cat([table, srt[::2]])).values
    _same(jk.member_sorted(ref_sorted, ref_table), tk.member_sorted(srt, table))
    rv, rc, _ = jk.unique_counts_sorted(ref_sorted)
    v, c, _ = tk.unique_counts_sorted(srt)
    for normal in (False, True):
        rn = ref_table[1::3] if normal else None
        n = table[1::3].contiguous() if normal else None
        for a, b in zip(jk.subtract_sorted(rv, rc, ref_table[::2], rn),
                        tk.subtract_sorted(v, c, table[::2].contiguous(), n)):
            _same(a, b)


@pytest.mark.parametrize("with_normal", [False, True])
def test_sample_only_kmers(with_normal):
    rng = np.random.default_rng(5)
    region = rng.integers(0, 4, 600).astype(np.int8)
    # sample: region reads (subtracted) + reads of a novel sequence, some
    # reverse-complemented, with N and short reads
    novel = rng.integers(0, 4, 200).astype(np.int8)
    reads = [region[s:s + 60] for s in range(0, 500, 7)]
    reads += [novel[s:s + 60] for s in range(0, 140, 3)]
    reads += [(3 - novel[s:s + 60])[::-1] for s in range(0, 140, 11)]
    codes = np.stack(reads).astype(np.int8)
    codes[rng.random(codes.shape) < 0.005] = 4
    lengths = np.full(len(codes), 60, dtype=np.int32)
    lengths[::9] = 12
    kw = {}
    if with_normal:
        n_codes = np.stack([novel[s:s + 60] for s in range(0, 60, 4)]).astype(np.int8)
        kw = dict(normal_codes=n_codes, normal_lengths=np.full(len(n_codes), 60, np.int32))
    ref = jk.sample_only_kmers(codes, lengths, region, K, **kw)
    got = tk.sample_only_kmers(codes, lengths, region, K, **kw, device="cpu")
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) > 0


def test_sample_only_kmers_empty_result():
    rng = np.random.default_rng(6)
    region = rng.integers(0, 4, 400).astype(np.int8)
    codes = np.stack([region[s:s + 50] for s in range(0, 300, 5)]).astype(np.int8)
    lengths = np.full(len(codes), 50, dtype=np.int32)
    ref = jk.sample_only_kmers(codes, lengths, region, K)
    got = tk.sample_only_kmers(codes, lengths, region, K, device="cpu")
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype and len(b) == 0
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("add_rc", [True, False])
def test_kmer_table_and_novel_support(add_rc):
    codes, lengths = _reads(7, R=30, L=80)
    ref = jk.kmer_table(codes, lengths, K, add_rc=add_rc)
    got = tk.kmer_table(codes, lengths, K, add_rc=add_rc, device="cpu")
    assert ref.dtype == got.dtype
    np.testing.assert_array_equal(ref, got)
    region, region_len = _reads(8, R=1, L=400, n_rate=0.0, short=False)
    ref_table = jk.kmer_table(region, region_len, K)
    assert np.array_equal(ref_table, tk.kmer_table(region, region_len, K, device="cpu"))
    for contig in (np.concatenate([region[0, :100], codes[0, :60]]), codes[3, :70],
                   region[0, :90]):
        want = jk.novel_kmer_normal_support(contig, ref_table, got, K)
        have = tk.novel_kmer_normal_support(contig, ref_table, got, K, device="cpu")
        assert want == have
