"""The port on the card: the CUDA Smith-Waterman kernel against the plain
torch version, and the k-mer engine on CUDA against the CPU, exact
(tolerance 0: integer outputs). Every test needs a CUDA card and nvcc and
skips without them. This file imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from breakmer_tpu_torch.ops import kmer, sw_cuda
from breakmer_tpu_torch.ops.sw import SWParams, sw_score, sw_score_batch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    return torch.device("cuda")


def _codes(rng, B, Lq, Lt, n_rate=0.0):
    q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.int8)
    for b in range(0, B, 3):  # planted exact copies
        n = min(Lq, Lt) // 2
        t[b, 7:7 + n] = q[b, :n]
    q[:, Lq - Lq // 8:] = 4  # trailing pad
    if n_rate:
        q[rng.random(q.shape) < n_rate] = 4
        t[rng.random(t.shape) < n_rate] = 4
    return q, t


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lt", [(37, 128, 256), (5, 1024, 2048), (3, 300, 40),
                                     (2, 10240, 512)])
def test_kernel_matches_plain(card, B, Lq, Lt):
    rng = np.random.default_rng(Lq + Lt)
    cases = [(False, 0.01, SWParams()), (True, 0.0, SWParams()),
             (True, 0.0, SWParams(3, 2, 4, 2)), (False, 0.0, SWParams(2, 0, 5, 1))]
    for no_n, n_rate, params in cases:
        q, t = (torch.from_numpy(a).to(card) for a in _codes(rng, B, Lq, Lt, n_rate))
        before = sw_cuda.LAUNCHES
        got = sw_cuda.sw_score_cuda(q, t, params, no_n=no_n)
        torch.cuda.synchronize()
        assert sw_cuda.LAUNCHES == before + 1
        ref = sw_score(q, t, params)
        for name, a, b in zip(("score", "q_end", "t_end"), ref, got):
            assert torch.equal(a, b), f"{name} no_n={no_n} {params}"


@pytest.mark.cuda
def test_sw_score_batch_goes_through_the_kernel(card):
    q, t = _codes(np.random.default_rng(3), 16, 128, 256)
    before = sw_cuda.LAUNCHES
    on_card = sw_score_batch(q, t, device=card)
    assert sw_cuda.LAUNCHES == before + 1
    on_cpu = sw_score_batch(q, t, device="cpu")
    for a, b in zip(on_cpu, on_card):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_kmer_engine_on_card_matches_cpu(card):
    rng = np.random.default_rng(4)
    region = rng.integers(0, 4, 3000).astype(np.int8)
    starts = rng.integers(0, 2850, 500)
    codes = np.stack([region[s:s + 150] for s in starts])
    err = rng.random(codes.shape) < 0.01  # substitution errors
    codes[err] = rng.integers(0, 4, int(err.sum()))
    lengths = np.full(len(codes), 150, dtype=np.int32)
    normal = codes[::4].copy()
    args = (codes, lengths, region, 15)
    kw = dict(normal_codes=normal, normal_lengths=lengths[::4])
    want = kmer.sample_only_kmers(*args, **kw, device="cpu")
    got = kmer.sample_only_kmers(*args, **kw, device=card)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
