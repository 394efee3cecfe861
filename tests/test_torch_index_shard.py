"""The mesh-sharded genome index: breakmer_tpu_torch.parallel.index_shard
over virtual meshes of 1, 3 and 8 CPU devices against
breakmer_tpu.parallel.index_shard over as many of its virtual CPU devices
(tests/conftest.py) and against GenomeIndex.candidates, on
tests/test_index_shard.py's three-chromosome genome. Windows, hits and
shard tables are exact."""

import numpy as np
import pytest
import torch

from breakmer_tpu.align.index import GenomeIndex as JaxGenomeIndex
from breakmer_tpu.parallel.index_shard import ShardedGenomeIndex as JaxSharded
from breakmer_tpu.parallel.index_shard import make_shard_mesh as jax_shard_mesh
from breakmer_tpu_torch.align.index import GenomeIndex
from breakmer_tpu_torch.encode import encode_seq
from breakmer_tpu_torch.ops.kmer import str_to_kmer
from breakmer_tpu_torch.parallel.index_shard import (
    AXIS_SHARDS, SENT_CODE, ShardedGenomeIndex, make_shard_mesh,
)
from tests.fixtures import rand_seq

DS = [1, 3, 8]
PROBE = "ACGTACGTACG"


def _mesh(D):
    return make_shard_mesh(devices=[torch.device("cpu")] * D)


@pytest.fixture(scope="module")
def genome():
    return {"chr1": rand_seq(11, 30_000), "chr2": rand_seq(12, 20_000),
            "chr3": rand_seq(13, 8_000)}


@pytest.fixture(scope="module")
def indexes(genome):
    """{D: (port ShardedGenomeIndex, JAX ShardedGenomeIndex)}, and the
    port's and the JAX package's GenomeIndex."""
    gi, jgi = GenomeIndex(genome, k=11), JaxGenomeIndex(genome, k=11)
    shards = {D: (ShardedGenomeIndex(gi, _mesh(D)), JaxSharded(jgi, jax_shard_mesh(D)))
              for D in DS}
    return shards, gi, jgi


def _win_key(w):
    return (w.chrom, w.t_start, w.t_end, w.strand, w.nseeds)


def _contigs(genome, kind, n=6, seed=3):
    rng = np.random.default_rng(seed)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    out = []
    for trial in range(n):
        seq = genome[("chr1", "chr2", "chr3")[trial % 3]]
        start = int(rng.integers(0, len(seq) - 400))
        contig = seq[start:start + 250]
        if kind == "revcomp":  # the '-' path
            contig = "".join(comp[b] for b in reversed(contig))
        elif kind == "split":  # two loci: the translocation shape
            contig = contig[:125] + genome["chr2"][5_000:5_125]
        out.append(encode_seq(contig))
    return out


@pytest.mark.parametrize("kind", ["forward", "revcomp", "split"])
@pytest.mark.parametrize("D", DS)
def test_candidates_match_jax_sharded_and_genome_index(indexes, genome, D, kind):
    shards, gi, jgi = indexes
    si, jsi = shards[D]
    for q in _contigs(genome, kind):
        want = [_win_key(w) for w in gi.candidates(q)]
        assert want and want == [_win_key(w) for w in jgi.candidates(q)]
        assert [_win_key(w) for w in jsi.candidates(q)] == want
        assert [_win_key(w) for w in si.candidates(q)] == want
    if kind == "split":
        assert len({w.chrom for w in si.candidates(q)}) >= 2


@pytest.mark.parametrize("D", DS)
def test_shard_tables_equal_jax_shard_for_shard(indexes, D):
    """The port's int64 shards are the JAX package's shard for shard. JAX
    runs without x64, so its device table is int32: every real entry is
    the same number, and the pad code SENT_CODE = 2^62 wraps to 0 there."""
    shards, _, _ = indexes
    si, jsi = shards[D]
    assert si.h_pad == jsi.h_pad
    assert si.mesh.axis_names == tuple(jsi.mesh.axis_names) == (AXIS_SHARDS,)
    assert si.mesh.devices.size == jsi.mesh.devices.size == D == len(si.shards)
    n_pad = 0
    for col, jax_col in enumerate((jsi._codes_d, jsi._pos_d, jsi._cid_d)):
        jax_shards = sorted(jax_col.addressable_shards, key=lambda s: s.index[0].start or 0)
        assert len(jax_shards) == D
        for shard, js in zip(si.shards, jax_shards):
            want = np.asarray(js.data)
            got = shard[col].numpy()
            assert got.dtype == np.int64 and want.dtype == np.int32
            real = got != (SENT_CODE if col == 0 else -1)
            assert (np.abs(got[real]) < 2 ** 31).all()
            np.testing.assert_array_equal(got.astype(np.int32), want)
            n_pad += int((~real).sum()) if col == 0 else 0
    assert n_pad == D * si.shards[0][0].numel() - 57970  # the seeds, padded to a multiple of D
    codes = np.concatenate([sh[0].numpy() for sh in si.shards])
    assert (np.diff(codes) >= 0).all()  # sorted through the pad: every shard searchable


def test_last_shard_lookup_matches_the_genome_index(indexes):
    """Every code of the last shard of 8 (whose pad the JAX package's
    int32 table leaves unsorted) gives GenomeIndex's hits."""
    shards, gi, _ = indexes
    si, _ = shards[8]
    codes = si.shards[-1][0].numpy()
    query = np.unique(codes[codes != SENT_CODE])[-200:]
    qi, cid, tp = si.lookup(query)
    got = sorted(zip(query[qi].tolist(), cid.tolist(), tp.tolist()))
    want = sorted((int(c), ci, int(p)) for c in query for ci, chrom in enumerate(gi.chroms)
                  for p in gi.lookup_chrom(chrom, int(c)))
    assert got == want and len(want) >= 200


@pytest.mark.parametrize("D", DS)
def test_lookup_spans_shard_boundaries(indexes, D):
    shards, gi, _ = indexes
    si, jsi = shards[D]
    want = sorted((chrom, int(p)) for chrom in gi.chroms
                  for p in gi.lookup_chrom(chrom, str_to_kmer(PROBE)))
    query = np.array([str_to_kmer(PROBE)], dtype=np.int64)
    qi, cid, tp = si.lookup(query)
    assert sorted((si.chroms[int(c)], int(p)) for c, p in zip(cid, tp)) == want
    # every hit of JAX's lookup, in its (shard, query, hit) order (its
    # chrom ids and positions come back int32: no x64)
    codes = np.concatenate([query, np.array([str_to_kmer(s) for s in
                                             ("AAAAAAAAAAA", "GATTACAGATT")])])
    for a, b in zip(jsi.lookup(codes), si.lookup(codes)):
        assert b.dtype == np.int64
        np.testing.assert_array_equal(a.astype(np.int64), b)


@pytest.mark.parametrize("D", DS)
def test_hpad_autosizes_for_multichrom_repeats(D):
    # a seed at the per-chrom cap on three chromosomes lands as one run
    # after the global code sort; auto h_pad must hold it
    genome = {f"chr{i}": (PROBE + rand_seq(40 + i, 9)) * 70 for i in range(1, 4)}
    gi = GenomeIndex(genome, k=11)
    si = ShardedGenomeIndex(gi, _mesh(D))
    jsi = JaxSharded(JaxGenomeIndex(genome, k=11), jax_shard_mesh(D))
    assert si.h_pad == jsi.h_pad > 64
    q = encode_seq(PROBE + "TTTTGGGGCCCCAAAA")
    want = [_win_key(w) for w in gi.candidates(q)]
    assert want and [_win_key(w) for w in si.candidates(q)] == want
    assert [_win_key(w) for w in jsi.candidates(q)] == want


@pytest.mark.parametrize("D", [1, 8])
def test_overflow_raises(D):
    # 2000 copies of one k-mer in one chromosome with uncapped seeds: a
    # single shard holds > h_pad hits -> explicit overflow, not silence
    genome = {"chrR": PROBE * 400}
    query = np.array([str_to_kmer(PROBE)], dtype=np.int64)
    si = ShardedGenomeIndex(GenomeIndex(genome, k=11, max_hits_per_seed=0), _mesh(D), h_pad=64)
    jsi = JaxSharded(JaxGenomeIndex(genome, k=11, max_hits_per_seed=0),
                     jax_shard_mesh(D), h_pad=64)
    for index in (jsi, si):
        with pytest.raises(OverflowError, match="h_pad=64"):
            index.lookup(query)


def test_empty_query(indexes):
    shards, _, _ = indexes
    si, jsi = shards[3]
    for index in (jsi, si):
        qi, cid, tp = index.lookup(np.empty(0, dtype=np.int64))
        assert len(qi) == len(cid) == len(tp) == 0
        assert index.candidates(encode_seq("ACGT" * 3)) == []


def test_host_surface_delegates_to_the_genome(indexes, genome):
    shards, gi, _ = indexes
    si, _ = shards[3]
    assert si.chroms == gi.chroms and si.k == 11
    assert si.length("chr2") == len(genome["chr2"])
    np.testing.assert_array_equal(si.fetch_codes("chr1", 100, 180),
                                  encode_seq(genome["chr1"][100:180]))
    assert si.shard_nbytes == 3 * 8 * si.shards[0][0].numel()
