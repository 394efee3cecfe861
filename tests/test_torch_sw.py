"""The port's plain Smith-Waterman (breakmer_tpu_torch.ops.sw) against the
JAX package: the XLA scan (breakmer_tpu.ops.sw.sw_score) and the Pallas
kernel in interpret mode, in its generic, no_n and target-chunked forms.
All outputs are integers, so every comparison is exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from breakmer_tpu.encode import ReadBatch
from breakmer_tpu.ops import sw as jsw
from breakmer_tpu.ops.sw_pallas import sw_score_pallas
from breakmer_tpu_torch.ops import sw as tsw
from breakmer_tpu_torch.ops import sw_cuda
from tests.test_sw import CASES, _pairs_to_batches, _random_cases

PARAMS = [(2, 3, 5, 1), (1, 1, 2, 1), (3, 2, 4, 2), (2, 0, 5, 1)]


def _port(q, t, params=(2, 3, 5, 1)):
    out = tsw.sw_score(torch.from_numpy(q), torch.from_numpy(t), tsw.SWParams(*params))
    return [x.numpy() for x in out]


def _jax(q, t, params=(2, 3, 5, 1)):
    out = jsw.sw_score(jnp.asarray(q), jnp.asarray(t), jsw.SWParams(*params))
    return [np.asarray(x) for x in out]


def _pallas(q, t, params=(2, 3, 5, 1), **kw):
    out = sw_score_pallas(jnp.asarray(q), jnp.asarray(t), jsw.SWParams(*params),
                          interpret=True, **kw)
    return [np.asarray(x) for x in out]


def _assert_same(ref, got, what=""):
    for name, a, b in zip(("score", "q_end", "t_end"), ref, got):
        assert a.dtype == b.dtype, f"{what} {name}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")


def _planted(seed, B, lq, lt, pad_q, pad_t, n_rate=0.0):
    """Random pairs with exact copies of the query planted in every third
    target, padded; ``n_rate`` sprinkles mid-sequence N."""
    rng = np.random.default_rng(seed)
    qs = ["".join(rng.choice(list("ACGT"), int(n))) for n in rng.integers(lq // 2, lq, B)]
    ts = ["".join(rng.choice(list("ACGT"), int(n))) for n in rng.integers(lt // 2, lt, B)]
    for i in range(0, B, 3):
        ts[i] = ts[i][:20] + qs[i] + ts[i][20:]
    q = ReadBatch.from_seqs(qs, pad_to=pad_q).codes[:, :pad_q]
    t = ReadBatch.from_seqs(ts, pad_to=pad_t).codes[:, :pad_t]
    if n_rate:
        q = np.where(rng.random(q.shape) < n_rate, np.int8(4), q)
        t = np.where(rng.random(t.shape) < n_rate, np.int8(4), t)
    return np.ascontiguousarray(q), np.ascontiguousarray(t)


@pytest.mark.parametrize("params", PARAMS)
def test_plain_matches_jax_scan(params):
    pairs = CASES + _random_cases()
    q, t = _pairs_to_batches(pairs, pad_q=64, pad_t=64)
    _assert_same(_jax(q, t, params), _port(q, t, params), f"{params}")


def test_plain_matches_jax_scan_n_and_odd_batch():
    # B = 37 (odd), ~2% mid-sequence N, rectangular
    q, t = _planted(31, 37, 60, 150, 64, 160, n_rate=0.02)
    for params in PARAMS[:3]:
        _assert_same(_jax(q, t, params), _port(q, t, params), f"{params}")


def test_plain_matches_pallas_generic():
    pairs = CASES + _random_cases(8)
    q, t = _pairs_to_batches(pairs, pad_q=128, pad_t=128)
    _assert_same(_pallas(q, t), _port(q, t), "generic")
    _assert_same(_pallas(q, t, (3, 2, 4, 2)), _port(q, t, (3, 2, 4, 2)), "params")


def test_plain_matches_pallas_no_n():
    q, t = _planted(32, 12, 120, 300, 128, 256)
    for params in ((2, 3, 5, 1), (3, 2, 4, 2)):
        _assert_same(_pallas(q, t, params, no_n=True), _port(q, t, params), f"no_n {params}")


def test_plain_matches_pallas_target_chunked():
    # 128-wide chunks over a 384 target, hits across chunk boundaries,
    # plus an N run straddling j == 128
    q, t = _planted(33, 8, 120, 380, 128, 384)
    _assert_same(_pallas(q, t, target_chunk=128), _port(q, t), "chunked")
    t2 = t.copy()
    t2[:, 124:132] = 4
    _assert_same(_pallas(q, t2, target_chunk=128), _port(q, t2), "chunked boundary-N")


def test_sw_score_batch_matches_jax_and_leaves_kernel_unlaunched():
    q, t = _planted(34, 9, 100, 200, 128, 256)
    before = sw_cuda.LAUNCHES
    got = tsw.sw_score_batch(q, t, tsw.SWParams(), no_n=True, device="cpu")
    auto = tsw.sw_score_auto(torch.from_numpy(q), torch.from_numpy(t))
    assert sw_cuda.LAUNCHES == before == 0
    ref = jsw.sw_score_batch(q, t, jsw.SWParams(), no_n=True)
    _assert_same([np.asarray(x) for x in ref], list(got), "batch")
    _assert_same(list(got), [x.numpy() for x in auto], "auto")


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros((2, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        sw_cuda.sw_score_cuda(q, q)
    assert sw_cuda.LAUNCHES == 0
