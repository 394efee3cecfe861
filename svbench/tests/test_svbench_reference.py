"""The plain references, against the program's own plain versions (which
the program's tests hold to the JAX package) and against hand counts."""

import numpy as np
import torch

from svbench.reference.kmer import kmer_codes, revcomp, sample_only
from svbench.reference.sw import sw


def test_sw_matches_the_programs_plain_version():
    from breakmer_tpu_torch.ops.sw import SWParams, sw_score

    rng = np.random.default_rng(3)
    for trial in range(40):
        B, Lq, Lt = int(rng.integers(1, 5)), int(rng.integers(1, 40)), int(rng.integers(1, 60))
        q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
        t = rng.integers(0, 4, (B, Lt)).astype(np.int8)
        if trial % 3 == 0:
            t[:, : min(Lq, Lt)] = q[:, : min(Lq, Lt)]
        q[:, Lq - int(rng.integers(0, 3)):] = 4
        t[:, Lt - int(rng.integers(0, 5)):] = 4
        p = SWParams()
        want = [x.numpy() for x in sw_score(torch.from_numpy(q), torch.from_numpy(t), p)]
        got = sw(q, t, p.match, p.mismatch, p.gap_open, p.gap_extend)
        for a, b in zip(want, got):
            assert np.array_equal(a, b), trial


def test_sw_by_hand():
    q = np.array([[0, 1, 2, 3]], np.int8)
    s, qe, te = sw(q, q.copy(), 2, 3, 5, 1)
    assert (s[0], qe[0], te[0]) == (8, 3, 3)
    s, qe, te = sw(np.array([[4, 4]], np.int8), np.array([[0, 1]], np.int8), 2, 3, 5, 1)
    assert (s[0], qe[0], te[0]) == (0, -1, -1)


def test_int16_control_saturates():
    q = np.zeros((1, 20000), np.int8)
    s16 = sw(q, q, 2, 3, 5, 1, bits=16)[0][0]
    assert sw(q, q, 2, 3, 5, 1)[0][0] == 40000 and s16 == 32767


def test_kmers_by_hand():
    codes = np.array([[0, 1, 2, 3, 4, 0]], np.int8)  # ACGTNA
    assert kmer_codes(codes, [6], 3).tolist() == [0b000110, 0b011011]
    assert revcomp(np.array([0b000110]), 3).tolist() == [0b011011]  # ACG <-> CGT


def test_sample_only_matches_the_programs_plain_version():
    from breakmer_tpu_torch.ops.kmer import sample_only_kmers_plain

    rng = np.random.default_rng(5)
    dropped = 0
    for trial in range(8):
        R, L = 60, 100
        reads = rng.integers(0, 4, (R, L)).astype(np.int8)
        reads[30:] = reads[:30]
        lens = rng.integers(20, L + 1, R).astype(np.int32)
        lens[30:] = lens[:30]
        ref = rng.integers(0, 4, 3000).astype(np.int8)
        ref[100:150] = reads[1, :50]
        nrm = rng.integers(0, 4, (10, L)).astype(np.int8)
        nrm[0, :60] = reads[1, 40:]
        nl = np.full(10, L, np.int32)
        a = sample_only_kmers_plain(reads, lens, ref, 15, nrm, nl, 2)
        b = sample_only(reads, lens, ref, 15, nrm, nl, 2)
        assert len(b[0]) > 0
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]), trial
        c = sample_only(reads, lens, ref, 15, nrm, nl, 2, table_bits=16)
        assert set(c[0]) <= set(b[0])
        dropped += len(b[0]) - len(c[0])
    assert dropped > 0
