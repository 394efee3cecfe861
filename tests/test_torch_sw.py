"""The port's plain Smith-Waterman (breakmer_tpu_torch.ops.sw) against the
JAX package: the XLA scan (breakmer_tpu.ops.sw.sw_score) and the Pallas
kernel in interpret mode, in its generic, no_n and target-chunked forms.
All outputs are integers, so every comparison is exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from breakmer_tpu.ops import sw as jsw
from breakmer_tpu.ops.sw_pallas import sw_score_pallas
from breakmer_tpu_torch.encode import ReadBatch
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


# -- the CUDA kernel's launch plan (plain Python, so it is tested here) -----

_LQ_TIERS = [128, 256, 512] + [1024 * k for k in range(1, 11)]
_LT_TIERS = [256, 512, 1024] + [2048 * k for k in range(1, 9)]


def _assert_legal(plan, B, Lq, Lt):
    R, S = plan.rows_per_lane, plan.strips
    assert R in sw_cuda.ROWS_PER_LANE
    assert plan.threads % 32 == 0 and 0 < plan.threads <= 1024
    assert plan.smem_bytes <= 227 * 1024
    # every pair and every strip exactly once, in (pair, strip) order
    assert plan.blocks * plan.threads // 32 >= plan.warps == B * S
    assert (plan.blocks - 1) * plan.threads // 32 < plan.warps
    # the kernel's item w is strip w % S of pair w // S
    items = [(w // S, w % S) for w in range(plan.warps)]
    assert items == [(b, k) for b in range(B) for k in range(S)]
    # the strips cover rows 0 .. Lq - 1 once, none of them empty
    assert 32 * R * (S - 1) < Lq <= 32 * R * S
    header = 1 + B + 3 * B * S if S > 1 else 0
    assert plan.header_ints == header
    assert plan.scratch_ints == -(-header // 4) * 4 + 4 * B * (S - 1) * Lt
    assert plan.pack == (2 * min(Lq, Lt) < 2 ** 15 and Lt <= 2 ** 16)


@pytest.mark.parametrize("B", [1, 2, 131, 133, 512])
def test_launch_plan_is_legal_for_every_realign_tier(B):
    for Lq in _LQ_TIERS:
        for Lt in _LT_TIERS:
            _assert_legal(sw_cuda.launch_plan(B, Lq, Lt), B, Lq, Lt)


def test_launch_plan_is_legal_for_the_smoke_shapes_and_every_R():
    from chip_smoke import SW_SHAPES

    for B, Lq, Lt in SW_SHAPES + [(3, 1, 1), (1, 129, 7), (4, 511, 3)]:
        for R in (None, *sw_cuda.ROWS_PER_LANE):
            _assert_legal(sw_cuda.launch_plan(B, Lq, Lt, R), B, Lq, Lt)
    with pytest.raises(ValueError):
        sw_cuda.launch_plan(2, 64, 64, rows_per_lane=3)


@pytest.mark.parametrize("match,Lq,Lt,pack", [
    (2, 2048, 2048, True), (16, 2047, 2048, True), (16, 2048, 2048, False),
    (16, 4096, 2048, False), (2, 64, 2 ** 16, True), (2, 64, 2 ** 16 + 1, False),
])
def test_launch_plan_packs_the_row_key_only_in_its_range(match, Lq, Lt, pack):
    """One key H * 2^16 + 65535 - j holds a row's best while the scores stay
    below 2^15 and j below 2^16; past that the kernel keeps them apart."""
    for R in sw_cuda.ROWS_PER_LANE:
        assert sw_cuda.launch_plan(3, Lq, Lt, R, match=match).pack is pack


def test_launch_plan_picks_rows_a_lane_by_its_estimate():
    """A larger R where the pairs fill the card, a smaller one where a few
    pairs must spread over more warps; the pick is the estimate's least."""
    picks = {shape: sw_cuda.launch_plan(*shape).rows_per_lane
             for shape in [(512, 256, 512), (301, 128, 256), (16, 1024, 6144),
                           (2, 10240, 2048)]}
    assert picks == {(512, 256, 512): 8, (301, 128, 256): 4, (16, 1024, 6144): 4,
                     (2, 10240, 2048): 8}
    for shape, R in picks.items():
        est = {r: sw_cuda.step_clocks(*shape, r) for r in sw_cuda.ROWS_PER_LANE}
        assert est[R] == min(est.values())
