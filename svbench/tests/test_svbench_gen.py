"""The generator: deterministic for a seed, the same work for every seed,
and files the program reads back as written."""

from collections import Counter

import numpy as np
import pytest

from svbench.gen.bam import write_bam
from svbench.gen.genome import write_2bit
from svbench.gen.sample import make_sample
from svbench.tests._util import maker


@pytest.mark.parametrize("config,mix", [("oncopanel_t", "sv_dense"), ("impact_tn", "clinical")])
def test_a_seed_makes_the_same_sample(config, mix):
    m = maker(config, mix)
    a, b = make_sample(m, 2**31 + 11, 0), make_sample(m, 2**31 + 11, 0)
    c = make_sample(m, 2**31 + 12, 0)
    for f in ("pos", "flag", "seq", "qual", "cig_len"):
        assert np.array_equal(getattr(a.tumour, f), getattr(b.tumour, f))
    assert [(s.kind, s.mid, s.size) for s in a.svs] == [(s.kind, s.mid, s.size) for s in b.svs]
    assert not np.array_equal(a.tumour.seq[:50], c.tumour.seq[:50])
    if a.normal is not None:
        assert np.array_equal(a.normal.seq, b.normal.seq)


def test_every_seed_plants_the_same_kinds_and_vafs():
    m = maker("oncopanel_t", "sv_dense", targets=10)
    plans = [make_sample(m, s, 0).svs for s in (3, 2**31 + 99, 123456789)]
    kinds = [Counter(sv.kind for sv in p) for p in plans]
    vafs = [sorted(round(sv.vaf, 6) for sv in p) for p in plans]
    assert kinds[0] == kinds[1] == kinds[2] and sum(kinds[0].values()) == 10
    assert vafs[0] == vafs[1] == vafs[2]


def test_the_two_samples_of_a_run_differ():
    m = maker("oncopanel_t", "sv_dense")
    a, b = make_sample(m, 7, 0), make_sample(m, 7, 1)
    assert [sv.mid for sv in a.svs] != [sv.mid for sv in b.svs]


def test_background_reads_carry_their_reference():
    m = maker("oncopanel_t", "clinical", targets=2)
    s = make_sample(m, 5, 0)
    r = s.tumour
    plain = (r.n_cig == 1) & (r.mapq == 60)
    g = m.genome
    names = g.names
    hits = total = 0
    for i in np.nonzero(plain)[0][:400]:
        ref = g.fetch(names[r.refid[i]], int(r.pos[i]), int(r.pos[i]) + 100)
        hits += int((ref == r.seq[i]).sum())
        total += 100
    assert hits / total > 0.97  # the error model's ~0.8 % substitutions


def test_bam_and_index_read_back(tmp_path):
    from breakmer_tpu_torch.io.bam import BamReader, read_bam

    m = maker("impact_tn", "sv_dense")
    s = make_sample(m, 11, 0)
    refs = [(c, m.genome.lengths[c]) for c in m.genome.names]
    n = write_bam(tmp_path / "t.bam", refs, s.tumour, "x")
    recs = list(BamReader(tmp_path / "t.bam"))
    assert len(recs) == n == len(s.tumour)
    keys = [(r.rname, r.pos) for r in recs]
    assert keys == sorted(keys, key=lambda k: (m.genome.names.index(k[0]), k[1]))
    assert all(len(r.seq) == 100 and len(r.qual) == 100 for r in recs)
    t = m.panel[1]
    fetched = list(read_bam(tmp_path / "t.bam", region=(t.chrom, t.start, t.end)))
    scanned = [r for r in recs if r.rname == t.chrom and not r.is_unmapped
               and r.pos < t.end and r.reference_end() > t.start]
    assert {r.qname + str(r.flag) for r in scanned} <= {r.qname + str(r.flag) for r in fetched}


def test_2bit_reads_back(tmp_path):
    from breakmer_tpu_torch.io.twobit import TwoBitReader

    m = maker("oncopanel_t", "sv_dense")
    write_2bit(tmp_path / "g.2bit", m.genome)
    tb = TwoBitReader(tmp_path / "g.2bit")
    for c in m.genome.names:
        assert tb.length(c) == m.genome.lengths[c]
        assert np.array_equal(tb.fetch_codes(c, 12345, 20000), m.genome.fetch(c, 12345, 20000))
