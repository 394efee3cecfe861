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


def _codes(rng, B, Lq, Lt, n_rate=0.0, pattern=None):
    """Random codes (or ``pattern`` repeated: many cells share the best
    score) with planted copies, a trailing query pad and ~``n_rate`` N."""
    q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.int8)
    if pattern is not None:
        q[:] = np.resize(np.array(pattern, np.int8), Lq)
        t[:] = np.resize(np.array(pattern, np.int8), Lt)
    for b in range(0, B, 3):  # planted exact copies
        n = min(Lq, Lt) // 2
        t[b, 7:7 + n] = q[b, :n]
    q[:, Lq - Lq // 8:] = 4  # trailing pad
    if n_rate:
        q[rng.random(q.shape) < n_rate] = 4
        t[rng.random(t.shape) < n_rate] = 4
    return q, t


_EDGES = [(3, 32 * R + dq, 300) for R in sw_cuda.ROWS_PER_LANE for dq in (-1, 0, 1)]


_PLAIN_CASES = [
    (37, 128, 256, None), (5, 1024, 2048, None), (3, 300, 40, None), (2, 10240, 512, None),
    *[(B, Lq, Lt, None) for B, Lq, Lt in _EDGES],            # strip edges, every R
    (4, 1, 50, None), (4, 50, 1, None), (2, 1, 1, None), (5, 20, 64, None),  # Lq, Lt tiny
    (1, 256, 512, None), (131, 256, 512, None), (133, 256, 512, None),  # B across the SMs
    (9, 200, 333, (0, 1)), (9, 300, 200, (0,)), (7, 600, 700, (0, 1, 2)),  # ties
    (2, 10240, 2048, None),                                  # a long query, many strips
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lt,pattern", _PLAIN_CASES)
def test_kernel_matches_plain(card, B, Lq, Lt, pattern):
    """Every case at the plan's own R and at each R forced, with the row
    best packed as the plan has it and forced unpacked, exact."""
    rng = np.random.default_rng(Lq + Lt)
    cases = [(False, 0.01, SWParams()), (True, 0.0, SWParams()),
             (True, 0.0, SWParams(3, 2, 4, 2)), (False, 0.0, SWParams(2, 0, 5, 1))]
    for no_n, n_rate, params in cases:
        q, t = (torch.from_numpy(a).to(card)
                for a in _codes(rng, B, Lq, Lt, n_rate, pattern))
        ref = sw_score(q, t, params)
        for R in (None, *sw_cuda.ROWS_PER_LANE):
            for unpacked in (False, True):
                before = sw_cuda.LAUNCHES
                got = sw_cuda.sw_score_cuda(q, t, params, no_n=no_n, rows_per_lane=R,
                                            unpacked=unpacked)
                torch.cuda.synchronize()
                assert sw_cuda.LAUNCHES == before + 1
                for name, a, b in zip(("score", "q_end", "t_end"), ref, got):
                    assert torch.equal(a, b), \
                        f"{name} no_n={no_n} {params} R={R} unpacked={unpacked}"
        if pattern is not None:
            assert int(ref[0].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lt,pattern", [
    (3, 2048, 2048, None), (3, 2048, 2048, (0, 1)), (2, 2100, 2500, (0,)),
])
def test_kernel_matches_plain_past_the_packed_key(card, B, Lq, Lt, pattern):
    """Scores of 2^15 and more: the plan itself keeps a row's best as score
    and column apart; exact at every R, tie-heavy inputs included."""
    rng = np.random.default_rng(Lq * Lt)
    for no_n, params in ((False, SWParams(40, 30, 50, 20)), (True, SWParams(40, 30, 50, 20)),
                         (False, SWParams(48, 0, 60, 10))):
        assert not sw_cuda.launch_plan(B, Lq, Lt, params=params).pack
        q, t = (torch.from_numpy(a).to(card) for a in _codes(rng, B, Lq, Lt, 0.0, pattern))
        ref = sw_score(q, t, params)
        assert int(ref[0].max()) >= 2 ** 15
        for R in (None, *sw_cuda.ROWS_PER_LANE):
            got = sw_cuda.sw_score_cuda(q, t, params, no_n=no_n, rows_per_lane=R)
            for name, a, b in zip(("score", "q_end", "t_end"), ref, got):
                assert torch.equal(a, b), f"{name} no_n={no_n} {params} R={R}"


_BLOCK_EDGES = [(3, 32 * R + dq, 300) for R in sw_cuda.BLOCK_ROWS_PER_LANE
                for dq in (-1, 0, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lt,pattern", _PLAIN_CASES + [
    *[(B, Lq, Lt, None) for B, Lq, Lt in _BLOCK_EDGES],      # the block form's strip edges
    (2, 1024, 777, None), (3, 1983, 512, None), (2, 2048, 300, None),  # 16-32 strips a block
    (1, 1, 1, None), (3, 1, 700, None), (3, 700, 1, None),   # Lq or Lt of 1
    (1, 512, 1024, None), (12, 512, 1024, None), (12, 1024, 2048, None),  # serial shapes
    (12, 256, 512, (0, 1)), (1, 1024, 2048, (0,)),           # ties
])
def test_block_form_matches_plain(card, B, Lq, Lt, pattern):
    """The block form (R = 2, up to Lq = 2048), packed as the plan has it
    and forced unpacked, exact, on the cases of test_kernel_matches_plain
    and the form's own; where it cannot take the shape, forcing it raises
    before any launch."""
    rng = np.random.default_rng(Lq + Lt + 1)
    cases = [(False, 0.01, SWParams()), (True, 0.0, SWParams()),
             (True, 0.0, SWParams(3, 2, 4, 2)), (False, 0.0, SWParams(2, 0, 5, 1))]
    for no_n, n_rate, params in cases:
        q, t = (torch.from_numpy(a).to(card)
                for a in _codes(rng, B, Lq, Lt, n_rate, pattern))
        ref = sw_score(q, t, params)
        for R in sw_cuda.BLOCK_ROWS_PER_LANE:
            for unpacked in (False, True):
                before = dict(sw_cuda.LAUNCHES_BY_FORM, all=sw_cuda.LAUNCHES)
                if -(-Lq // (32 * R)) > 32:
                    with pytest.raises(ValueError):
                        sw_cuda.sw_score_cuda(q, t, params, no_n=no_n, rows_per_lane=R)
                    assert dict(sw_cuda.LAUNCHES_BY_FORM, all=sw_cuda.LAUNCHES) == before
                    continue
                got = sw_cuda.sw_score_cuda(q, t, params, no_n=no_n, rows_per_lane=R,
                                            unpacked=unpacked)
                torch.cuda.synchronize()
                assert sw_cuda.LAUNCHES == before["all"] + 1
                assert sw_cuda.LAUNCHES_BY_FORM["block"] == before["block"] + 1
                for name, a, b in zip(("score", "q_end", "t_end"), ref, got):
                    assert torch.equal(a, b), \
                        f"{name} no_n={no_n} {params} R={R} unpacked={unpacked}"
        if pattern is not None:
            assert int(ref[0].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lt,pattern", [
    (3, 2048, 2048, None), (3, 2048, 2048, (0, 1)), (2, 1024, 2500, (0,)),
])
def test_block_form_past_the_packed_key(card, B, Lq, Lt, pattern):
    """Best scores of 2^15 and more in the block form, where the plan
    itself unpacks: exact, ties included."""
    rng = np.random.default_rng(Lq * Lt + 1)
    for no_n, params in ((False, SWParams(40, 30, 50, 20)), (True, SWParams(40, 30, 50, 20)),
                         (False, SWParams(48, 0, 60, 10))):
        q, t = (torch.from_numpy(a).to(card) for a in _codes(rng, B, Lq, Lt, 0.0, pattern))
        ref = sw_score(q, t, params)
        assert int(ref[0].max()) >= 2 ** 15
        for R in sw_cuda.BLOCK_ROWS_PER_LANE:
            if -(-Lq // (32 * R)) > 32:
                continue
            assert not sw_cuda.launch_plan(B, Lq, Lt, R, params=params).pack
            got = sw_cuda.sw_score_cuda(q, t, params, no_n=no_n, rows_per_lane=R)
            for name, a, b in zip(("score", "q_end", "t_end"), ref, got):
                assert torch.equal(a, b), f"{name} no_n={no_n} {params} R={R}"


@pytest.mark.cuda
def test_forcing_a_form_the_shape_cannot_take_raises_before_any_launch(card):
    q = torch.zeros((2, 2049), dtype=torch.int8, device=card)
    t = torch.zeros((2, 300), dtype=torch.int8, device=card)
    before = dict(sw_cuda.LAUNCHES_BY_FORM, all=sw_cuda.LAUNCHES)
    for R in (1, 2, 3):  # 33 strips of 64 rows; R of no form
        with pytest.raises(ValueError):
            sw_cuda.sw_score_cuda(q, t, rows_per_lane=R)
    torch.cuda.synchronize()
    assert dict(sw_cuda.LAUNCHES_BY_FORM, all=sw_cuda.LAUNCHES) == before
    sw_cuda.sw_score_cuda(q, t)  # the plan takes the ticket form
    assert sw_cuda.LAUNCHES_BY_FORM["ticket"] == before["ticket"] + 1


@pytest.mark.cuda
def test_serial_shapes_launch_the_block_form(card):
    """A launch of realign's serial path (few pairs) takes the block form
    under the plan and is counted under it."""
    rng = np.random.default_rng(13)
    for B, Lq, Lt in ((1, 256, 512), (1, 256, 1024), (12, 512, 1024)):
        q, t = (torch.from_numpy(a).to(card) for a in _codes(rng, B, Lq, Lt))
        before = dict(sw_cuda.LAUNCHES_BY_FORM)
        got = sw_cuda.sw_score_cuda(q, t, no_n=True)
        assert sw_cuda.LAUNCHES_BY_FORM == dict(before, block=before["block"] + 1)
        for a, b in zip(sw_score(q, t), got):
            assert torch.equal(a, b)


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


# -- the probe kernels and the region step (every comparison exact) --------

from breakmer_tpu_torch.parallel.step import make_region_step, to_numpy  # noqa: E402
from breakmer_tpu_torch.tools import probe_mosaic_cummax as cm  # noqa: E402
from breakmer_tpu_torch.tools import probe_swar_i16 as i16  # noqa: E402
from breakmer_tpu_torch.tools import probe_swar_i16b as i16b  # noqa: E402
from breakmer_tpu_torch.tools import sw_ceiling_probe as ceil  # noqa: E402


_CEIL_STEPS = [0, 1, 7, 8, 9, 31, 32, 33, 255, None]  # around R = 8, the unroll


@pytest.mark.cuda
@pytest.mark.parametrize("do_rolls", [True, False])
@pytest.mark.parametrize("steps", _CEIL_STEPS)
def test_ceiling_probe_kernel_matches_plain(card, do_rolls, steps):
    q, t = ceil.inputs(card)
    before = ceil.LAUNCHES
    got = ceil.stripped(q, t, do_rolls, steps)
    torch.cuda.synchronize()
    assert ceil.LAUNCHES == before + 1
    assert torch.equal(got, ceil.stripped_plain(q, t, do_rolls, steps))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lt", [(5, 1, 2), (3, 31, 40), (6, 32, 32), (5, 33, 33),
                                     (9, 256, 300), (3, 300, 400), (2, 512, 520)])
def test_ceiling_probe_kernel_other_shapes(card, B, Lq, Lt):
    """Every R (1 at Lq = 1 to 16 at 512), ragged and whole last threads,
    rows past one block; each step count around the unroll by R."""
    rng = np.random.default_rng(Lq)
    q = torch.from_numpy(rng.integers(-50, 50, (B, Lq)).astype(np.int8)).to(card)
    t = torch.from_numpy(rng.integers(-50, 50, (B, Lt)).astype(np.int8)).to(card)
    for do_rolls in (True, False):
        for steps in _CEIL_STEPS + [Lq - 1, Lq + 3]:
            assert torch.equal(ceil.stripped(q, t, do_rolls, steps),
                               ceil.stripped_plain(q, t, do_rolls, steps)), (do_rolls, steps)


@pytest.mark.cuda
@pytest.mark.parametrize("mod", [i16, i16b], ids=["i16", "i16b"])
def test_probe_i16_ops_match_plain(card, mod):
    before = mod.LAUNCHES
    rows = mod.run_ops(mod.OPS, mod.run_op, mod.inputs(), card)
    assert [r["name"] for r in rows if not r["exact"]] == []
    assert mod.LAUNCHES > before


def _full_range(shape, seed):
    rng = np.random.default_rng(seed)
    full = lambda: rng.integers(-32768, 32768, shape).astype(np.int16)  # noqa: E731
    arrays = {"A": full(), "B": full(), "H": full(), "BH": full(), "BD": full(),
              "M": rng.integers(0, 2, shape).astype(np.int16) * -1,
              "ONEHOT": np.where(np.arange(shape[1]) == 0, -1, 0).astype(np.int16)
              * np.ones(shape, np.int16),
              "Q32": rng.integers(0, 5, shape).astype(np.int32),
              "T32": rng.integers(0, 5, shape).astype(np.int32)}
    arrays["A32"] = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    return arrays


# the indicator op is left out: the kernel's compare equals the probe's
# indicator arithmetic only while |h - bh| < 2^15
_WRAP_OPS = [op for op in i16.OPS + i16b.OPS if op.name != "indicator-select (bd update)"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 256), (4, 1024), (2, 33), (2, 1), (2, 544), (18, 100)])
def test_probe_i16_ops_wrap_like_numpy(card, shape):
    """Full-range int16 inputs: every op wraps as the plain int16 torch op
    does; every RW, ragged last threads, and row pairs past one block."""
    rows = i16.run_ops(_WRAP_OPS, i16.run_op, _full_range(shape, shape[1]), card)
    assert [r["name"] for r in rows if not r["exact"]] == []


@pytest.mark.cuda
def test_probe_i16_ops_on_unaligned_inputs(card):
    """Inputs and output whose addresses are not aligned to the wide
    loads: the kernel loads and stores element by element, exact."""
    def unaligned(a):
        flat = torch.empty(a.size + 1, dtype=torch.from_numpy(a).dtype, device=card)
        x = flat[1:].view(a.shape)
        x.copy_(torch.from_numpy(a))
        assert x.data_ptr() % 16 and x.is_contiguous()
        return x

    arrays = _full_range((4, 256), 3)
    x = {k: unaligned(v) for k, v in arrays.items()}
    for op in _WRAP_OPS:
        xs = [x[a] for a in op.args]
        assert torch.equal(i16.run_op(op, *xs), op.plain(*xs)), op.name


@pytest.mark.cuda
def test_redesigned_probe_wrappers_count_one_launch_a_call(card):
    """One call of each wrapper: exactly one launch on its count; a width
    the layout refuses raises before any launch."""
    q, t = ceil.inputs(card)
    x = {k: torch.from_numpy(v).to(card) for k, v in i16.inputs().items()}
    calls = [(ceil, lambda: ceil.stripped(q, t, True, 9)),
             (i16, lambda: i16.run_op(i16.OPS[9], x["A"])),
             (i16b, lambda: i16b.run_op(i16b.OPS[7], x["Q32"], x["T32"]))]
    for mod, call in calls:
        before = mod.LAUNCHES
        call()
        torch.cuda.synchronize()
        assert mod.LAUNCHES == before + 1, mod.__name__
    before = ceil.LAUNCHES, i16.LAUNCHES
    wide = torch.zeros((2, 513), dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="lanes"):
        ceil.stripped(wide, wide, True, 3)
    with pytest.raises(ValueError, match="lanes"):
        i16.run_op(i16.OPS[0], *(torch.zeros((2, 1025), dtype=torch.int16, device=card),) * 2)
    assert (ceil.LAUNCHES, i16.LAUNCHES) == before


_P_EDGES = [1, 2, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257, 511, 512, 513, 1000,
            1024]
_CUMMAX_SHAPES = [(8, 256), (5, 1000), (3, 33), (1, 1), (2, 1024),
                  *[(R, W) for W in _P_EDGES for R in (1, 3, 8)],  # every P, a few rows
                  (263, 257), (1029, 128), (2113, 1000),  # rows past whole blocks of 2, 4, 8
                  (16384, 1024)]  # a bandwidth shape: 64 MiB in, 64 MiB out


def _cummax_once(x):
    """One call of the kernel's wrapper: one launch, equal to the plain version."""
    before = cm.LAUNCHES
    got = cm.cummax(x)
    torch.cuda.synchronize()
    assert cm.LAUNCHES == before + 1
    assert got.is_contiguous() and torch.equal(got, cm.cummax_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _CUMMAX_SHAPES)
def test_cummax_kernel_matches_plain(card, shape):
    """Full-range int32 at every P and both load forms (16-byte vectors
    where W % 4 == 0 and P >= 4), rows that end inside a block."""
    rng = np.random.default_rng(shape[1])
    x = torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                         .astype(np.int32)).to(card)
    _cummax_once(x)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 33, 256, 1000, 1024])
def test_cummax_kernel_at_the_extremes(card, W):
    """All INT_MIN (the padding's own value), all INT_MAX, a falling row
    and a lone maximum; each warps a block forced."""
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    rows = np.stack([np.full(W, lo), np.full(W, hi), np.arange(W)[::-1] + lo,
                     np.where(np.arange(W) == W // 2, hi, lo)]).astype(np.int32)
    x = torch.from_numpy(np.tile(rows, (3, 1))).to(card)
    _cummax_once(x)
    for warps in range(1, cm.MAX_WARPS + 1):
        assert torch.equal(cm.cummax(x, warps=warps), cm.cummax_plain(x)), warps


@pytest.mark.cuda
def test_cummax_kernel_on_non_contiguous_and_unaligned_inputs(card):
    """A column slice, a transposed view and a contiguous input at an
    address off the 16-byte vectors: each one launch, exact."""
    rng = np.random.default_rng(5)
    base = torch.from_numpy(rng.integers(-2**31, 2**31, (40, 520), dtype=np.int64)
                            .astype(np.int32)).to(card)
    flat = torch.empty(9 * 256 + 1, dtype=torch.int32, device=card)
    unaligned = flat[1:].view(9, 256)
    unaligned.copy_(base[:9, :256])
    assert unaligned.data_ptr() % 16 and unaligned.is_contiguous()
    for x in (base[:, 3:259], base[:8, :33].t(), unaligned):
        _cummax_once(x)


@pytest.mark.cuda
def test_cummax_refusals_launch_nothing(card):
    before = cm.LAUNCHES
    for bad in (torch.zeros((2, 1025), dtype=torch.int32, device=card),
                torch.zeros((2, 0), dtype=torch.int32, device=card),
                torch.zeros((2, 8), dtype=torch.int64, device=card),
                torch.zeros(8, dtype=torch.int32, device=card)):
        with pytest.raises(ValueError):
            cm.cummax(bad)
    with pytest.raises(ValueError, match="warps"):
        cm.cummax(torch.zeros((2, 8), dtype=torch.int32, device=card), warps=9)
    assert cm.cummax(torch.zeros((0, 8), dtype=torch.int32, device=card)).shape == (0, 8)
    assert cm.LAUNCHES == before


@pytest.mark.cuda
def test_region_step_on_card_matches_cpu(card):
    rng = np.random.default_rng(11)
    G, R, L, Lref, B, Lq, Lt = 3, 40, 100, 700, 6, 64, 160
    arrays = (rng.integers(0, 4, (G, R, L)).astype(np.int8),
              rng.integers(L // 2, L + 1, (G, R)).astype(np.int32),
              rng.integers(0, 4, (G, Lref)).astype(np.int8),
              np.full(G, Lref, np.int32),
              rng.integers(0, 4, (G, B, Lq)).astype(np.int8),
              rng.integers(0, 4, (G, B, Lt)).astype(np.int8))
    arrays[0][:, R // 2:, :50] = arrays[0][:, :R // 2, 50:]  # repeated k-mers
    step = make_region_step(mesh=None, k=15)
    before = sw_cuda.LAUNCHES
    got = to_numpy(step(*(torch.from_numpy(a).to(card) for a in arrays)))
    assert sw_cuda.LAUNCHES == before + 1  # one SW launch for all G * B pairs
    want = to_numpy(step(*map(torch.from_numpy, arrays)))
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (want[1] >= 2).any()


@pytest.mark.cuda
def test_cli_profile_traces_the_card(card, tmp_path):
    import json

    from breakmer_tpu_torch.cli import main
    from breakmer_tpu_torch.testing.scenarios import build_scenario

    cfg_kwargs, _ = build_scenario(1, tmp_path, n_genes=2, kinds=["ins", "del"])
    cfg_kwargs.update(device="cuda", batch_regions=False, log_level="WARNING")
    cfg_kwargs.pop("reference_data_dir", None)
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps(cfg_kwargs))
    out = {}
    for name, extra in (("plain", []), ("profiled", ["--profile"])):
        assert main(["run", str(cfg_file), "--analysis-dir", str(tmp_path / name),
                     *extra]) == 0
        out[name] = (tmp_path / name / "output" / "prop_svs.out").read_bytes()
    assert out["profiled"] == out["plain"]
    trace = json.loads((tmp_path / "profiled" / "trace" / "trace.json").read_text())
    kernels = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"}
    assert any("sw_wavefront" in k for k in kernels), sorted(kernels)[:20]
    # every launch of the SW kernel lies inside a breakmer.realign range and
    # of K5 inside breakmer.kmer_device, on the host's timeline
    events = trace["traceEvents"]
    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    for part, stage in (("sw_wavefront", "realign"), ("region_kmers_kernel", "kmer_device")):
        ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"] == f"breakmer.{stage}"]
        launches = [launched_at[e["args"]["correlation"]] for e in events
                    if e.get("cat") == "kernel" and part in e["name"]]
        assert launches and ranges, (part, stage)
        outside = [t for t in launches if not any(s <= t <= end for s, end in ranges)]
        assert not outside, (part, stage, len(outside), len(launches))


# -- the batched panel path (k-mer batch step, batched runner) ---------------

def _batch_regions():
    """Regions whose reads carry a novel insertion; a matched normal that
    covers one of the insertions and is missing for another region."""
    from breakmer_tpu_torch.encode import ReadBatch, encode_seq
    from breakmer_tpu_torch.testing.fixtures import rand_seq

    out = []
    for i in range(6):
        ref = rand_seq(300 + i, 900 + 150 * i)
        hap = ref[:400] + rand_seq(400 + i, 60) + ref[400:]
        reads = ReadBatch.from_seqs([hap[s:s + 90] for s in range(200, 560, 3 + i)])
        normal = None if i == 4 else ReadBatch.from_seqs(
            [(hap if i == 1 else ref)[s:s + 90] for s in range(250, 600, 11)])
        out.append((f"K{i}", reads, encode_seq(ref), normal))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [512, 1], ids=["packed", "overflow"])
def test_kmer_batch_on_card_matches_cpu(card, slots, monkeypatch):
    from breakmer_tpu_torch.parallel import kmer_batch as kb

    monkeypatch.setattr(kb, "_PACK_SLOTS_PER_REGION", slots)
    out = {}
    for dev in ("cpu", card):
        pipe = kb.KmerBatchPipeline(15, regions_per_batch=2, device=dev)
        for r in _batch_regions():
            pipe.add(*r)
        out[str(dev)] = (pipe.finish(), pipe.refetched)
    (want, want_refetched), (got, got_refetched) = out.values()
    assert list(got) == list(want) and got_refetched == want_refetched
    assert (got_refetched > 0) == (slots == 1)
    for name in want:
        for a, b in zip(want[name], got[name]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_kmer_batch_step_forms_on_card_match_cpu(card):
    """The full and the packed step, raw outputs, card against CPU."""
    from breakmer_tpu_torch.parallel import kmer_batch as kb
    from breakmer_tpu_torch.parallel.regions import pack_region_batches

    batches = pack_region_batches(_batch_regions(), 4)
    assert len(batches) > 1  # several pad tiers
    for b in batches:
        args = [torch.from_numpy(a) for a in kb._step_args(b)]
        cap = 4 * kb._PACK_SLOTS_PER_REGION
        for step in (kb._kmer_body(15, 2), kb._kmer_step_packed(15, 2, cap)):
            want = step(*args)
            got = step(*(a.to(card) for a in args))
            for a, g in zip(want, got):
                assert a.dtype == g.dtype and torch.equal(a, g.cpu())
        assert int(want[2]) > 0  # the packed step found k-mers, no overflow


@pytest.mark.cuda
def test_cli_batched_run_on_card_launches_the_kernel(card, tmp_path):
    import json

    from breakmer_tpu_torch.cli import main
    from breakmer_tpu_torch.testing.scenarios import build_scenario
    from breakmer_tpu_torch.utils.meter import METER

    cfg_kwargs, _ = build_scenario(1, tmp_path, n_genes=2, kinds=["ins", "del"])
    cfg_kwargs.update(batch_regions=True, log_level="WARNING")
    cfg_kwargs.pop("reference_data_dir", None)
    out = {}
    for dev in ("cpu", "cuda"):
        cfg_file = tmp_path / f"{dev}.json"
        cfg_file.write_text(json.dumps({**cfg_kwargs, "device": dev}))
        before = sw_cuda.LAUNCHES
        assert main(["run", str(cfg_file), "--analysis-dir", str(tmp_path / dev)]) == 0
        out[dev] = (tmp_path / dev / "output" / "prop_svs.out").read_bytes()
    assert sw_cuda.LAUNCHES - before == METER.sw_launches > 0  # every SW batch
    assert out["cuda"] == out["cpu"] and out["cuda"].count(b"\n") > 1


# -- device time, and the sharded forms over a virtual mesh on the card -------

@pytest.mark.cuda
def test_device_us_counts_the_ctypes_kernel(card):
    """``timing.device_us`` reads the SW kernel (a ctypes launch, under no
    torch op) within 10 % of the queued-events device time."""
    from breakmer_tpu_torch.timing import device_us, queued_ms

    q, t = (torch.from_numpy(a).to(card) for a in _codes(np.random.default_rng(9), 512, 256, 512))
    fn = lambda: sw_cuda.sw_score_cuda(q, t, no_n=True)  # noqa: E731
    queued = queued_ms(fn, n=20) * 1e3
    profiled = device_us(fn)
    assert profiled > 0
    assert abs(profiled - queued) <= 0.10 * queued, (profiled, queued)


def _card_mesh(card, n=4):
    from breakmer_tpu_torch.parallel.mesh import make_mesh_2d

    return make_mesh_2d(devices=[torch.device("cuda", torch.cuda.current_device())] * n)


@pytest.mark.cuda
def test_sharded_region_step_on_card_matches_unsharded_and_cpu(card):
    rng = np.random.default_rng(12)
    G, R, L, Lref, B, Lq, Lt = 4, 40, 100, 700, 6, 64, 160
    arrays = (rng.integers(0, 4, (G, R, L)).astype(np.int8),
              rng.integers(L // 2, L + 1, (G, R)).astype(np.int32),
              rng.integers(0, 4, (G, Lref)).astype(np.int8),
              np.full(G, Lref, np.int32),
              rng.integers(0, 4, (G, B, Lq)).astype(np.int8),
              rng.integers(0, 4, (G, B, Lt)).astype(np.int8))
    arrays[0][:, R // 2:, :50] = arrays[0][:, :R // 2, 50:]  # repeated k-mers
    on_card = [torch.from_numpy(a).to(card) for a in arrays]
    mesh = _card_mesh(card)
    before = sw_cuda.LAUNCHES
    got = make_region_step(mesh=mesh, k=15)(*on_card)
    torch.cuda.synchronize()
    assert sw_cuda.LAUNCHES == before + 4  # one SW launch a shard
    assert all(x.device == mesh.first for x in got)
    want = to_numpy(make_region_step(mesh=None, k=15)(*map(torch.from_numpy, arrays)))
    single = to_numpy(make_region_step(mesh=None, k=15)(*on_card))
    for a, b, c in zip(want, to_numpy(got), single):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [512, 1], ids=["packed", "overflow"])
def test_sharded_kmer_batch_on_card_matches_cpu(card, slots, monkeypatch):
    from breakmer_tpu_torch.parallel import kmer_batch as kb

    monkeypatch.setattr(kb, "_PACK_SLOTS_PER_REGION", slots)
    pipes = [kb.KmerBatchPipeline(15, regions_per_batch=4, device="cpu"),
             kb.KmerBatchPipeline(15, mesh=_card_mesh(card), regions_per_batch=4)]
    for pipe in pipes:
        for r in _batch_regions():
            pipe.add(*r)
    want, got = (p.finish() for p in pipes)
    assert list(got) == list(want) and pipes[1].refetched == pipes[0].refetched
    for name in want:
        for a, b in zip(want[name], got[name]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 4])
def test_sharded_index_on_card_matches_genome_index(card, D):
    from breakmer_tpu_torch.align.index import GenomeIndex
    from breakmer_tpu_torch.encode import encode_seq, revcomp_codes
    from breakmer_tpu_torch.parallel.index_shard import ShardedGenomeIndex, make_shard_mesh
    from breakmer_tpu_torch.testing.fixtures import rand_seq

    genome = {f"chr{i}": rand_seq(60 + i, 20_000) + rand_seq(7, 500) for i in range(1, 5)}
    gi = GenomeIndex(genome, k=11)
    si = ShardedGenomeIndex(gi, make_shard_mesh(devices=[card] * D))
    assert all(x.device.type == "cuda" for shard in si.shards for x in shard)
    assert si.h_pad >= 4  # the shared 500 bp tail: one seed run over four chromosomes
    rng = np.random.default_rng(D)
    key = lambda ws: [(w.chrom, w.t_start, w.t_end, w.strand, w.nseeds) for w in ws]  # noqa: E731
    for n in range(24):
        chrom = f"chr{n % 4 + 1}"
        s = int(rng.integers(0, 20_200))
        q = encode_seq(genome[chrom][s:s + 250])
        if n % 3 == 1:
            q = revcomp_codes(q)
        want = key(gi.candidates(q))
        assert want and key(si.candidates(q)) == want


@pytest.mark.cuda
@pytest.mark.parametrize("R", sw_cuda.ROWS_PER_LANE)
@pytest.mark.parametrize("unpacked", [False, True], ids=["packed", "unpacked"])
def test_agreement_pad_rows_match_plain(card, R, unpacked):
    """gpu_agreement's 64x(256x512) pad-tier case, generic form: its
    mid-sequence pad (row 4's query tail, row 2's N run) and all-pad row
    (5) through the kernel at each R, packed and unpacked, exact."""
    from breakmer_tpu_torch.tools import gpu_agreement

    cases = gpu_agreement.build_cases(np.random.default_rng(gpu_agreement.SEED))
    _, paths, _ = next(c for c in cases if c[0] == "64x(256x512)")
    _, q, t, _ = next(p for p in paths if p[0] == "generic")
    assert (q[5] == 4).all() and (q[4, 128:] == 4).all() and (q[2, 85:90] == 4).all()
    q, t = torch.from_numpy(q).to(card), torch.from_numpy(t).to(card)
    want = sw_score(q, t)
    got = sw_cuda.sw_score_cuda(q, t, rows_per_lane=R, unpacked=unpacked)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert int(want[0][5]) == 0


# -- the k-mer engine's kernels (csrc/kmer.cu) against their plain versions --

from breakmer_tpu_torch.ops import kmer_cuda  # noqa: E402
from breakmer_tpu_torch.parallel.step import _per_region_kmers  # noqa: E402

_SENT = kmer_cuda.SENTINEL


def _launched(name, fn):
    """fn() and that it launched ``name`` once (and no other k-mer kernel)."""
    before = dict(kmer_cuda.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    after = dict(before, **{name: before[name] + 1})
    assert kmer_cuda.LAUNCHES == after, (name, before, kmer_cuda.LAUNCHES)
    return out


def _equal(want, got):
    want, got = ((x if isinstance(x, tuple) else (x,)) for x in (want, got))
    for a, b in zip(want, got, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _read_codes(rng, R, L, k, n_rate=0.02):
    """Codes with N as any byte 4..127, an all-N row, and lengths below k,
    inside the row and past L."""
    codes = rng.integers(0, 4, (R, L)).astype(np.int8)
    mask = rng.random((R, L)) < n_rate
    codes[mask] = rng.integers(4, 128, int(mask.sum()))
    lengths = rng.integers(L // 2, L + 1, R).astype(np.int32)
    if R >= 4:
        codes[1] = 4
        lengths[2], lengths[3] = k - 1, L + 9
    return codes, lengths


# the main path's shapes (a region's sample batch, its reference row, a
# contig window) and the batch step's (G = 32 x R = 512 reads of 128)
_KMER_SHAPES = [(200, 100), (1, 3000), (1, 60), (32 * 512, 128), (5, 15), (3, 16), (1, 5000)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [-2, -1, 0, 1, 5, 11, 15])
@pytest.mark.parametrize("R,L", _KMER_SHAPES)
def test_kmer_codes_kernel_matches_plain(card, k, R, L):
    rng = np.random.default_rng(R + L + k)
    codes, lengths = (torch.from_numpy(a).to(card) for a in _read_codes(rng, R, L, k))
    want = kmer.kmer_codes_plain(codes, lengths, k)
    got = _launched("kmer_codes", lambda: kmer.kmer_codes(codes, lengths, k))
    _equal(want, got)
    # strided inputs (every other column and read), made contiguous by the wrapper
    wide = torch.from_numpy(np.repeat(_read_codes(rng, 2 * R, L, k)[0], 2, axis=1)).to(card)
    lens = torch.from_numpy(rng.integers(0, L + 3, 2 * R).astype(np.int32)).to(card)
    strided, lens = wide[::2, ::2], lens[::2]
    assert not strided.is_contiguous()
    _equal(kmer.kmer_codes_plain(strided, lens, k),
           _launched("kmer_codes", lambda: kmer.kmer_codes(strided, lens, k)))


@pytest.mark.cuda
def test_kmer_codes_kernel_on_all_n_and_every_byte(card):
    codes = torch.from_numpy(np.arange(-128, 128, dtype=np.int16).astype(np.int8)
                             .reshape(8, 32)).to(card)
    for rows, lengths in ((codes, [32] * 8), (torch.full_like(codes, 4), [32] * 8),
                          (codes.remainder(4).to(torch.int8), [0, 1, 14, 15, 16, 31, 32, 99])):
        lens = torch.tensor(lengths, dtype=torch.int32, device=card)
        for k in (1, 15):
            _equal(kmer.kmer_codes_plain(rows, lens, k),
                   _launched("kmer_codes", lambda: kmer.kmer_codes(rows, lens, k)))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [-1, 0, 1, 5, 11, 15])
def test_revcomp_kernel_matches_plain(card, k):
    rng = np.random.default_rng(k % 1000)  # (a seed >= 0)
    codes, lengths = (torch.from_numpy(a).to(card) for a in _read_codes(rng, 64, 200, k))
    km = kmer.kmer_codes_plain(codes, lengths, k)[0]
    for x in (km, km.reshape(-1), km[:, ::3], km.t(),
              torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, 999)).to(card)):
        _equal(kmer.revcomp_kmers_plain(x, k),
               _launched("revcomp_kmers", lambda: kmer.revcomp_kmers(x, k)))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [-2, 0, 1, 5, 11, 15])
def test_both_strands_kernel_matches_plain(card, k):
    """The both-strand form (one launch of the revcomp_kmers kernel)
    against its plain version, torch.cat of the codes and their reverse
    complements: a region's reference row and the batch step's [32, 4082],
    at both tile sizes (2 codes a thread below 132 blocks, 8 at or above),
    an odd width (code by code), rows off the 16-byte line, a strided view,
    one code, and values of any int64."""
    rng = np.random.default_rng(30 + k)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    codes, lengths = (torch.from_numpy(a).to(card) for a in _read_codes(rng, 32, 4096, k))
    km = kmer.kmer_codes_plain(codes, lengths, k)[0]
    flat = on(rng.integers(0, 1 << 30, 1201))
    cases = [km[:1], km[0], km, km[:3, :1001], flat[1:].view(2, 600), km[::2, ::3],
             on(np.array([_SENT])), on(rng.integers(-(1 << 62), 1 << 62, (200, 3000))),
             on(rng.integers(0, 1 << 32, (7, 5)))]
    for x in cases:
        want = kmer.both_strands_plain(x, k)
        _equal(want, _launched("revcomp_kmers", lambda: kmer.both_strands(x, k)))
        assert want.shape == (*x.shape[:-1], 2 * x.shape[-1])


def _sorted_rows(rng, G, N, hi, sent_from=None):
    x = np.sort(rng.integers(0, hi, (G, N)), axis=1)
    if sent_from is not None:
        x[:, sent_from:] = _SENT
    return x


@pytest.mark.cuda
def test_unique_counts_kernel_matches_plain(card):
    rng = np.random.default_rng(21)
    rows = {
        "sample": _sorted_rows(rng, 1, 200 * 86, 3000, 16000)[0],
        "batch": _sorted_rows(rng, 32, 512 * 114, 5000, 50000),
        "poly_a": np.zeros(200 * 86, dtype=np.int64),
        "poly_a_batch": np.zeros((4, 5000), dtype=np.int64),
        "all_sentinel": np.full((3, 77), _SENT, dtype=np.int64),
        "single": np.array([7], dtype=np.int64),
        "runs_across_rows": np.array([[1, 2, 9, 9], [9, 9, 9, 9], [9, 10, _SENT, _SENT]]),
        "ends_at_the_row_end": np.array([0, 3, 3, 3, 3, 3]),
    }
    for name, x in rows.items():
        t = torch.from_numpy(x.astype(np.int64)).to(card)
        for s in (t, t[..., ::2]):  # strided: every other slot of a sorted row stays sorted
            _equal(kmer.unique_counts_sorted_plain(s),
                   _launched("unique_counts_sorted", lambda: kmer.unique_counts_sorted(s)))
    v, c, _ = kmer.unique_counts_sorted(torch.zeros(200 * 86, dtype=torch.int64, device=card))
    assert int(c[0]) == 200 * 86 and int(c.sum()) == 200 * 86


@pytest.mark.cuda
def test_unique_counts_kernel_on_tile_edges(card):
    """The tile scan's edges, exact against the plain version, one launch
    a call, at both of the launch's tile sizes (2 slots a thread where 8
    would leave an SM idle): runs that cross one tile and many (the last
    warp's search past the tile), poly-A rows, all-SENTINEL rows, n = 1, a
    ragged last tile, SENTINEL from inside a tile, an odd n and rows off
    the 16-byte line (slot by slot), runs of every length, and the batch
    step's shape on tiled errored reads."""
    rng = np.random.default_rng(26)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(card)

    every = np.repeat(np.arange(300), np.arange(1, 301))
    G, R, L, LREF = 32, 512, 128, 4096
    hap = rng.integers(0, 4, (G, LREF)).astype(np.int8)
    starts = rng.integers(0, LREF - L + 1, (G, R))
    reads = hap[np.arange(G)[:, None, None], starts[:, :, None] + np.arange(L)]
    err = rng.random(reads.shape) < 0.01
    reads[err] = rng.integers(0, 4, int(err.sum()))
    km = kmer.kmer_codes_plain(torch.from_numpy(reads.reshape(G * R, L)).to(card),
                               torch.full((G * R,), L, dtype=torch.int32, device=card), 15)[0]
    tiled = torch.sort(km.reshape(G, -1), -1).values
    off = on(np.concatenate([[0], np.sort(rng.integers(0, 60, (2, 1000)), 1).ravel()]))
    cases = {
        "poly_a_region": on(np.zeros(200 * 86)),
        "poly_a_rows": on(np.zeros((140, 5000))),
        "runs_across_many_tiles": on(_sorted_rows(rng, 1, 20000, 5)),
        "runs_across_many_tiles_rows": on(_sorted_rows(rng, 140, 2100, 3)),
        "runs_across_one_tile": on(_sorted_rows(rng, 140, 2100, 150, 2000)),
        "all_sentinel_rows": on(np.full((3, 77), _SENT)),
        "n_1": on(np.array([42])), "n_1_sentinel": on(np.array([_SENT])),
        "n_1_rows": on(np.array([[4], [_SENT], [9]])),
        "ragged_last_tile": on(_sorted_rows(rng, 3, 1550, 40, 1500)),
        "sentinel_inside_a_tile": on(_sorted_rows(rng, 2, 1024, 20, 300)),
        "odd_n": on(_sorted_rows(rng, 5, 1333, 50, 1300)),
        "off_the_line": off[1:].view(2, 1000),
        "runs_of_every_length": on(every[:20000]),
        "runs_of_every_length_rows": on(np.repeat(every[None, :4000], 140, 0)),
        "batch_tiled_reads": tiled,
    }
    for name, x in cases.items():
        want = kmer.unique_counts_sorted_plain(x)
        got = _launched("unique_counts_sorted", lambda: kmer.unique_counts_sorted(x))
        _equal(want, got)
        assert int(got[1].sum()) == int((x != _SENT).sum()), name


@pytest.mark.cuda
def test_subtract_kernel_matches_plain(card):
    rng = np.random.default_rng(22)

    def counted(G, N, hi):
        s = torch.from_numpy(_sorted_rows(rng, G, N, hi, N - N // 8)).to(card)
        return kmer.unique_counts_sorted_plain(s)[:2]

    def table(G, M, hi):
        return torch.from_numpy(_sorted_rows(rng, G, M, hi, M - M // 10)).to(card)

    v1, c1 = (x[0] for x in counted(1, 200 * 86, 6000))
    v32, c32 = counted(32, 512 * 114, 9000)
    all_sent = torch.full((32, 256 * 114), _SENT, dtype=torch.int64, device=card)
    cases = {
        "region": (v1, c1, table(1, 2 * 2986, 6000)[0], table(1, 300 * 86, 6000)[0]),
        "region_no_normal": (v1, c1, table(1, 2 * 2986, 6000)[0], None),
        "batch": (v32, c32, table(32, 2 * 4082, 9000), table(32, 256 * 114, 9000)),
        "batch_empty_normal": (v32, c32, table(32, 2 * 4082, 9000), all_sent),
        "strided": (v32[:, ::2], c32[:, ::2], table(32, 2 * 4082, 9000)[:, ::2],
                    table(32, 2 * 4082, 9000)[:, 1::2]),
        "poly_a": (*kmer.unique_counts_sorted_plain(
            torch.zeros(5000, dtype=torch.int64, device=card))[:2],
            torch.arange(1, 100, device=card), torch.zeros(1, dtype=torch.int64, device=card)),
        "all_sentinel_sample": (torch.full((40,), _SENT, dtype=torch.int64, device=card),
                                torch.zeros(40, dtype=torch.int32, device=card),
                                torch.arange(0, 50, device=card), None),
    }
    for name, (v, c, ref, normal) in cases.items():
        want = kmer.subtract_sorted_plain(v, c, ref, normal)
        got = _launched("subtract_sorted", lambda: kmer.subtract_sorted(v, c, ref, normal))
        _equal(want, got)
        if name.startswith(("region", "batch")):
            kept = int((got[0] != _SENT).sum())
            assert 0 < kept < int((v != _SENT).sum()), name
    # a table of width 0 is refused before anything launches (the plain
    # version indexes past it)
    v, c = v32[:2], c32[:2]
    empty = torch.empty((2, 0), dtype=torch.int64, device=card)
    before = dict(kmer_cuda.LAUNCHES)
    for ref, normal in ((empty, empty), (empty, None), (v, empty)):
        with pytest.raises(ValueError, match="width 0"):
            kmer.subtract_sorted(v, c, ref, normal)
    torch.cuda.synchronize()
    assert kmer_cuda.LAUNCHES == before


@pytest.mark.cuda
def test_kmer_codes_kernel_on_span_edges(card):
    """The span design's edges, exact against the plain version, at both
    of the launch's forms (8 windows a thread where that fills the card, 2
    below): spans that cross rows, R * W not a multiple of the span, k = 1,
    L < 16 (every window starts a row: the rolling path), a contig window
    and a row of 5,000 bases, poly-A rows, negative bytes (the rolling path
    and its direct codes), and codes that start off a 16-byte line."""
    rng = np.random.default_rng(24)

    def reads(R, L, n_rate=0.03, neg_rate=0.0):
        codes = rng.integers(0, 4, (R, L)).astype(np.int8)
        codes[rng.random((R, L)) < n_rate] = 4
        neg = rng.random((R, L)) < neg_rate
        codes[neg] = rng.integers(-128, 0, int(neg.sum()))
        return codes, rng.integers(L // 2, L + 3, R).astype(np.int32)

    cases = [(*reads(37, 23), 5), (*reads(3, 700), 15), (*reads(9, 30), 1), (*reads(300, 15), 15),
             (*reads(250, 9), 4), (*reads(1, 60), 15), (*reads(1, 5000, 0.002), 15),
             (np.zeros((200, 100), np.int8), np.full(200, 100, np.int32), 15),
             (*reads(512, 128, 0.02, 0.03), 15), (*reads(64, 64, 0.02, 0.03), 7),
             (*reads(32 * 512, 128, 0.01, 0.0005), 15), (*reads(3000, 120, 0.02), 11)]
    for codes, lengths, k in cases:
        c, n = torch.from_numpy(codes).to(card), torch.from_numpy(lengths).to(card)
        _equal(kmer.kmer_codes_plain(c, n, k), _launched("kmer_codes", lambda: kmer.kmer_codes(c, n, k)))
        for off in (1, 7, 13):  # a contiguous view off the 16-byte line
            flat = torch.from_numpy(np.concatenate([np.zeros(off, np.int8), codes.reshape(-1)]))
            view = flat.to(card)[off:].view(codes.shape)
            assert view.is_contiguous() and view.data_ptr() % 16 == off
            _equal(kmer.kmer_codes_plain(view, n, k),
                   _launched("kmer_codes", lambda: kmer.kmer_codes(view, n, k)))


@pytest.mark.cuda
def test_subtract_kernel_on_tile_edges(card):
    """The tile design's edges, exact against the plain version, at both of
    the launch's forms (8 slots a thread where that fills the card, 2
    below): queries in any order, a table range wider than the staged
    chunk, tiles of SENTINEL alone, poly-A, an odd row width and views off
    the 16-byte line (slot by slot), many rows of several tiles, and values
    past 32 bits or negative (the 64-bit search)."""
    rng = np.random.default_rng(25)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    def counted(G, N, hi, sent_from):
        s = on(_sorted_rows(rng, G, N, hi, sent_from))
        return kmer.unique_counts_sorted_plain(s)[:2]

    def table(G, M, hi):
        return on(_sorted_rows(rng, G, M, hi, M - M // 10))

    v, c = counted(4, 9000, 6000, 8000)
    shuffled = v[:, torch.from_numpy(rng.permutation(9000)).to(card)].contiguous()
    dense = on(np.sort(rng.integers(0, 6000, (4, 12000)), axis=1))
    pv, pc = kmer.unique_counts_sorted_plain(torch.zeros((3, 5000), dtype=torch.int64,
                                                         device=card))[:2]
    ov, oc = counted(1, 4097, 3000, 4097)
    bv, bc = counted(32, 512 * 114, 9000, 50000)
    bshuf = bv[:, torch.from_numpy(rng.permutation(512 * 114)).to(card)].contiguous()
    wide = torch.from_numpy(np.sort(rng.integers(-(1 << 40), 1 << 40, (3, 5000)), axis=1)).to(card)
    wv, wc = kmer.unique_counts_sorted_plain(wide)[:2]
    wtab = torch.sort(torch.cat([wide[:, ::3], on(rng.integers(-(1 << 40), 1 << 40, (3, 900)))],
                                1), 1).values
    cases = {
        "unsorted_queries": (shuffled, c, table(4, 3000, 6000), table(4, 5000, 6000)),
        "range_wider_than_a_chunk": (v, c, dense, table(4, 30000, 6000)),
        "tiles_of_sentinel_alone": (*counted(2, 20000, 900, 2500), table(2, 500, 900), None),
        "poly_a": (pv, pc, on(np.array([[0, 5, _SENT]] * 3)), on(np.array([[1, 2]] * 3))),
        "poly_a_kept": (pv, pc, on(np.array([[1, 5, _SENT]] * 3)), None),
        "odd_n": (ov, oc, table(1, 777, 3000), table(1, 311, 3000)),
        "off_the_line": (v[0, 1:], c[0, 1:], table(1, 800, 6000)[0], table(1, 900, 6000)[0]),
        "many_rows": (*counted(40, 5000, 4000, 4500), table(40, 600, 4000),
                      table(40, 2000, 4000)),
        "unsorted_batch": (bshuf, bc, table(32, 2 * 4082, 9000), table(32, 256 * 114, 9000)),
        "wide_values": (wv, wc, wtab, wide[:, 1::7].contiguous()),
        "wide_values_batch": (wv.repeat(50, 1), wc.repeat(50, 1), wtab.repeat(50, 1), None),
    }
    for name, (v_, c_, ref, normal) in cases.items():
        want = kmer.subtract_sorted_plain(v_, c_, ref, normal)
        got = _launched("subtract_sorted", lambda: kmer.subtract_sorted(v_, c_, ref, normal))
        _equal(want, got)
        if name.startswith(("unsorted", "range", "odd", "many", "wide")):
            kept = int((got[0] != _SENT).sum())
            assert 0 < kept < int((v_ != _SENT).sum()), name


@pytest.mark.cuda
def test_kmer_kernels_refuse_on_card(card):
    before = dict(kmer_cuda.LAUNCHES)
    i8 = torch.zeros((2, 20), dtype=torch.int8, device=card)
    with pytest.raises(TypeError, match="lengths"):
        kmer.kmer_codes(i8, torch.zeros(2, dtype=torch.int64, device=card), 5)
    with pytest.raises(ValueError, match="one CUDA device"):
        kmer.kmer_codes(i8, torch.zeros(2, dtype=torch.int32), 5)
    with pytest.raises(TypeError, match="counts"):
        kmer.subtract_sorted(torch.zeros(3, dtype=torch.int64, device=card),
                             torch.zeros(3, dtype=torch.int64, device=card),
                             torch.zeros(3, dtype=torch.int64, device=card))
    with pytest.raises(ValueError, match="capacity"):
        kmer.kmer_codes(i8, torch.zeros(2, dtype=torch.int32, device=card), 16)
    # zero-size inputs: empty outputs, no launch (CUDA refuses a 0-block grid)
    km, valid = kmer.kmer_codes(i8[:0], torch.zeros(0, dtype=torch.int32, device=card), 15)
    assert km.shape == valid.shape == (0, 6)
    e = torch.empty((4, 0), dtype=torch.int64, device=card)
    assert kmer.revcomp_kmers(e, 15).shape == (4, 0)
    assert [o.shape for o in kmer.unique_counts_sorted(e)] == [(4, 0)] * 3
    assert kmer.subtract_sorted(e, e.to(torch.int32), e)[0].shape == (4, 0)
    torch.cuda.synchronize()
    assert kmer_cuda.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("with_normal", [False, True])
def test_kmer_host_wrappers_on_card_match_cpu(card, with_normal):
    """sample_only_kmers, kmer_table and novel_kmer_normal_support on the
    card equal their CPU outputs, through the kernels."""
    rng = np.random.default_rng(23)
    region = rng.integers(0, 4, 3000).astype(np.int8)
    novel = rng.integers(0, 4, 300).astype(np.int8)
    hap = np.concatenate([region[:1500], novel, region[1500:]])
    codes = np.stack([hap[s:s + 100] for s in rng.integers(0, len(hap) - 100, 200)])
    codes[rng.random(codes.shape) < 0.005] = 4
    lengths = np.full(len(codes), 100, dtype=np.int32)
    lengths[::17] = 9  # shorter than k
    kw = {}
    if with_normal:
        n_codes = np.stack([hap[s:s + 100] for s in rng.integers(0, 1650, 80)])
        kw = dict(normal_codes=n_codes, normal_lengths=np.full(80, 100, np.int32))
    cases = [("sample", (codes, lengths, region, 15)),
             ("poly_a", (np.zeros((50, 100), np.int8), np.full(50, 100, np.int32), region, 15)),
             ("empty_batch", (codes[:0], lengths[:0], region, 15))]
    for name, args in cases:
        for route in ("fused", "per_function"):  # the plan's, then the other, forced
            before = dict(kmer_cuda.LAUNCHES)
            got = kmer.sample_only_kmers(*args, **kw, device=card,
                                         route=None if route == "fused" else route)
            moved = {n: kmer_cuda.LAUNCHES[n] - before[n] for n in before
                     if kmer_cuda.LAUNCHES[n] != before[n]}
            want = kmer.sample_only_kmers(*args, **kw, device="cpu")
            for a, b in zip(want, got):
                assert a.dtype == b.dtype and np.array_equal(a, b), (name, route)
            sample = name != "empty_batch"  # an empty batch launches nothing for the sample
            assert moved == ({"region_kmers": 1} if route == "fused" else
                             {"kmer_codes": 1 + sample + with_normal, "revcomp_kmers": 1,
                              **({"unique_counts_sorted": 1, "subtract_sorted": 1}
                                 if sample else {})}), (name, route)
    assert len(got[0]) == 0 and len(want[0]) == 0
    assert len(kmer.sample_only_kmers(*cases[0][1], **kw, device=card)[0]) > 0
    before = kmer_cuda.LAUNCHES["kmer_codes"]
    ref_args = (region.reshape(1, -1), np.array([3000], np.int32), 15)
    ref_table = kmer.kmer_table(*ref_args, device=card)
    normal_table = kmer.kmer_table(codes, lengths, 15, device=card)
    contigs = (hap[1450:1600], hap[:60], novel[:40])
    support = [kmer.novel_kmer_normal_support(c, ref_table, normal_table, 15, device=card)
               for c in contigs]
    assert kmer_cuda.LAUNCHES["kmer_codes"] == before + 5
    assert np.array_equal(ref_table, kmer.kmer_table(*ref_args, device="cpu"))
    assert np.array_equal(normal_table, kmer.kmer_table(codes, lengths, 15, device="cpu"))
    assert support == [kmer.novel_kmer_normal_support(c, ref_table, normal_table, 15,
                                                      device="cpu") for c in contigs]
    assert any(n > 0 for n, _ in support)


@pytest.mark.cuda
def test_per_region_kmers_on_card_matches_cpu(card):
    """The batched form at the batch step's shapes, with a matched normal
    (all PAD in region 0), through one launch of each kernel but
    kmer_codes (three: sample, reference, normal)."""
    G, R, L, LREF, RN = 32, 512, 128, 4096, 256
    rng = np.random.default_rng(24)
    hap = rng.integers(0, 4, (G, LREF)).astype(np.int8)
    refs = hap.copy()
    refs[:, 2048:2304] = rng.integers(0, 4, (G, 256))  # 256 novel bases a region

    def tile(n, hi):
        starts = rng.integers(0, hi - L + 1, (G, n))
        return hap[np.arange(G)[:, None, None], starts[:, :, None] + np.arange(L)]

    normal, normal_lengths = tile(RN, 2176), np.full((G, RN), L, np.int32)
    normal[0], normal_lengths[0] = 4, 0
    host = [torch.from_numpy(a) for a in (tile(R, LREF), np.full((G, R), L, np.int32), refs,
                                          np.full(G, LREF, np.int32), normal, normal_lengths)]
    want = _per_region_kmers(*host, k=15, min_count=2)
    before = dict(kmer_cuda.LAUNCHES)
    got = _per_region_kmers(*(a.to(card) for a in host), k=15, min_count=2)
    torch.cuda.synchronize()
    moved = {n: kmer_cuda.LAUNCHES[n] - before[n] for n in before}
    assert moved == {"kmer_codes": 3, "revcomp_kmers": 1, "unique_counts_sorted": 1,
                     "subtract_sorted": 1, "region_kmers": 0}
    _equal(tuple(want), tuple(g.cpu() for g in got))
    assert int((want[1] > 0).sum()) > 0


# -- the region kernel (csrc/region_kmers.cu): a serial region's whole
# -- sample_only_kmers in one launch ------------------------------------------

from breakmer_tpu_torch.tools import kmer_time  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(kmer_time.REGION_CASES))
def test_region_kernel_matches_plain(card, name):
    """Each region case through sample_only_kmers on the card against the
    plain chain: the plan's route (one launch of the region kernel and no
    other where it fits, K1-K4 past the boundary), exact; then the fused
    route forced, which launches or raises before any launch."""
    args, kw = kmer_time.region_case(name)
    want = kmer.sample_only_kmers_plain(*args, **kw, device=card)
    plan = _card_plan(args, kw, card)
    before, routes = dict(kmer_cuda.LAUNCHES), dict(kmer.ROUTES)
    got = kmer.sample_only_kmers(*args, **kw, device=card)
    moved = {n: kmer_cuda.LAUNCHES[n] - before[n] for n in before
             if kmer_cuda.LAUNCHES[n] != before[n]}
    for a, b in zip(want, got, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert kmer.ROUTES == dict(routes, **{plan.route: routes[plan.route] + 1})
    assert (name == "boundary_over") == (plan.route == "per_function")
    if plan.route == "fused":
        assert moved == {"region_kmers": 1}
    else:
        assert moved["kmer_codes"] >= 2 and "region_kmers" not in moved
        before = dict(kmer_cuda.LAUNCHES)
        with pytest.raises(ValueError, match="shared memory"):
            kmer.sample_only_kmers(*args, **kw, device=card, route="fused")
        assert kmer_cuda.LAUNCHES == before


def _card_plan(args, kw, card, cluster=None):
    normal = kw.get("normal_codes")
    return kmer_cuda.card_plan(np.shape(args[0]), len(args[2]),
                               None if normal is None else normal.shape, args[3], card, cluster)


@pytest.mark.cuda
def test_region_plan_bytes_are_the_kernels(card):
    """kmer_cuda.region_smem_bytes, the plan's reckoning, equals the
    launch's own (region_kmers_smem_bytes of the library) over sizes on
    both sides of the card's limit at every cluster size, and the plan
    reads the card's limit and cluster sizes (an H100's: every size up to
    16)."""
    from breakmer_tpu_torch import _build

    lib = _build.library()
    if "H100" in torch.cuda.get_device_name(card):
        assert kmer_cuda.smem_optin(card) == kmer_cuda.H100_SMEM_OPTIN
        assert kmer_cuda.cluster_sizes(card) == kmer_cuda.H100_CLUSTERS
    assert kmer_cuda.cluster_sizes(card)[:1] == (1,)
    for C in kmer_cuda.REGION_CLUSTERS:
        for R in (0, 1, 7, 200, 308, 309, 600, 1232, 4886):
            for L, L_r, L_n, k in ((100, 1800, 102, 15), (37, 1001, 0, 11),
                                   (15, 30_000, 20, 1), (150, 15, 0, 15), (250, 1800, 0, 15)):
                want = kmer_cuda.region_smem_bytes(R, L - k + 1, max(L, L_r, L_n), C)
                assert lib.region_kmers_smem_bytes(R, L, L_r, L_n, k, C) == want, \
                    (R, L, L_r, L_n, k, C)
    for C in kmer_cuda.REGION_CLUSTERS:
        for L_r, normal, k in ((1800, (160, 102), 15), (15, None, 15), (1001, (13, 29), 11),
                               (30_000, (5000, 150), 1), (1800, (0, 100), 15)):
            R_n, L_n = normal or (0, 0)
            assert lib.region_kmers_scratch_words(L_r, R_n, L_n, k, C) == \
                kmer_cuda.region_scratch_words(L_r, normal if R_n else None, k, C), (L_r, normal)
    assert lib.region_kmers_smem_bytes(5, 10, 1800, 0, 11, 1) == -1
    assert lib.region_kmers_smem_bytes(5, 100, 1800, 0, 16, 1) == -1
    assert lib.region_kmers_smem_bytes(5, 100, 1800, 0, 15, 3) == -1
    assert lib.region_kmers_max_clusters(3, card.index or 0) == -1


def _fits_at(args, kw, card, C):
    return C in kmer_cuda.cluster_sizes(card) and _card_plan(args, kw, card, C).route == "fused"


_CLUSTER_CASES = [n for n in kmer_time.REGION_CASES if n != "boundary_over"]


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", kmer_cuda.REGION_CLUSTERS)
@pytest.mark.parametrize("name", _CLUSTER_CASES)
def test_region_kernel_at_each_cluster_size(card, name, cluster):
    """Each region case that a cluster of C CTAs takes, forced to C, one
    launch, exact against the plain chain; a size it does not take raises
    before any launch."""
    args, kw = kmer_time.region_case(name)
    before = dict(kmer_cuda.LAUNCHES)
    if not _fits_at(args, kw, card, cluster):
        with pytest.raises(ValueError, match="shared memory"):
            kmer_cuda.region_kmers(*args, **kw, device=card, cluster=cluster)
        assert kmer_cuda.LAUNCHES == before
        return
    want = kmer.sample_only_kmers_plain(*args, **kw, device=card)
    v, c = kmer_cuda.region_kmers(*args, **kw, device=card, cluster=cluster)
    got = kmer._by_count(v, c, kw["min_count"])
    for a, b in zip(want, got, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b), (name, cluster)
    assert {n: kmer_cuda.LAUNCHES[n] - before[n] for n in before
            if kmer_cuda.LAUNCHES[n] != before[n]} == {"region_kmers": 1}


@pytest.mark.cuda
def test_region_kernel_phase_clocks(card):
    """The clock stamps of each CTA's phases: eleven a CTA, none before the
    one before, at the plan's size and at one block; a clocks tensor of
    another shape raises before any launch."""
    args, kw = kmer_time.region_case("serial")
    segments, total = kmer_cuda.region_pack(args[0], args[1], args[2], kw["normal_codes"],
                                            kw["normal_lengths"])
    staged = kmer_cuda.region_stage(segments, total, card)
    windows = args[0].shape[0] * (args[0].shape[1] - args[3] + 1)
    want = kmer.sample_only_kmers_plain(*args, **kw, device="cpu")
    for C in (_card_plan(args, kw, card).cluster, 1):
        clocks = torch.zeros((C, kmer_cuda.REGION_PHASES), dtype=torch.int64, device=card)
        out = kmer_cuda.region_fetch(kmer_cuda.region_run(staged, segments, args[3],
                                                          kw["min_count"], windows, C, clocks))
        got = kmer._by_count(*out, kw["min_count"])
        assert all(np.array_equal(a, b) for a, b in zip(want, got))
        stamps = clocks.cpu().numpy()
        assert (stamps > 0).all() and (np.diff(stamps, axis=1) >= 0).all(), stamps
    before = dict(kmer_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="clocks"):
        kmer_cuda.region_run(staged, segments, args[3], kw["min_count"], windows, 2,
                             torch.zeros((1, kmer_cuda.REGION_PHASES), dtype=torch.int64,
                                         device=card))
    assert kmer_cuda.LAUNCHES == before


@pytest.mark.cuda
def test_region_launch_refuses_a_cluster_size_it_does_not_take(card):
    """A launch of 3 CTAs, or of one block past a block's layout, is
    refused by the launch entry with nothing launched, and the wrapper
    raises."""
    from breakmer_tpu_torch import _build

    for name, C in (("serial", 3), ("past_old_limit", 1)):
        args, kw = kmer_time.region_case(name)
        segments, total = kmer_cuda.region_pack(args[0], args[1], args[2],
                                                kw.get("normal_codes"), kw.get("normal_lengths"))
        staged = kmer_cuda.region_stage(segments, total, card)
        windows = args[0].shape[0] * (args[0].shape[1] - args[3] + 1)
        before = dict(kmer_cuda.LAUNCHES)
        with pytest.raises(_build.KernelLaunchError):
            kmer_cuda.region_run(staged, segments, args[3], kw["min_count"], windows, C)
        torch.cuda.synchronize()
        assert kmer_cuda.LAUNCHES == before


@pytest.mark.cuda
def test_region_kernel_refusals_launch_nothing(card):
    """What the per-function route refuses, the plan's route and the fused
    route refuse before any launch, with the same error: k past 15, a
    reference or reads shorter than k, lengths of another shape, an empty
    normal table against sample windows."""
    args, kw = kmer_time.region_case("serial")
    codes, lengths, ref, k = args
    before = dict(kmer_cuda.LAUNCHES)
    cases = [((codes, lengths, ref, 16), kw, "capacity"),
             ((codes, lengths, ref[:10], k), kw, "shorter"),
             ((codes[:, :10], lengths, ref, k), kw, "shorter"),
             ((codes, lengths[:5], ref, k), kw, "want"),
             (args, dict(kw, normal_codes=kw["normal_codes"][:, :9]), "shorter"),
             (args, dict(kw, normal_codes=kw["normal_codes"][:0],
                         normal_lengths=kw["normal_lengths"][:0]), "width 0")]
    for a, w, match in cases:
        for route in (None, "fused"):
            with pytest.raises(ValueError, match=match):
                kmer.sample_only_kmers(*a, **w, device=card, route=route)
        assert kmer_cuda.LAUNCHES == before, match
        with pytest.raises(ValueError, match=match):  # (which may launch first)
            kmer.sample_only_kmers(*a, **w, device=card, route="per_function")
        before = dict(kmer_cuda.LAUNCHES)


@pytest.mark.cuda
def test_region_kernel_result_layout(card):
    """The launch's own result buffer at the plan's cluster size: the kept
    runs, the runs, then the kept (value, count) pairs ascending by value,
    no pair past them."""
    args, kw = kmer_time.region_case("serial")
    segments, total = kmer_cuda.region_pack(args[0], args[1], args[2], kw["normal_codes"],
                                            kw["normal_lengths"])
    staged = kmer_cuda.region_stage(segments, total, card)
    plan = _card_plan(args, kw, card)
    windows = args[0].shape[0] * (args[0].shape[1] - args[3] + 1)
    assert plan.cluster > 1 and plan.windows == windows
    out = kmer_cuda.region_run(staged, segments, args[3], kw["min_count"], windows,
                               plan.cluster).cpu().numpy()
    kept, runs = int(out[0]), int(out[1])
    pairs = out[2:2 + 2 * kept].reshape(-1, 2)
    v = pairs[:, 0].view(np.uint32)
    assert 0 < kept <= runs <= windows and (np.diff(v.astype(np.int64)) > 0).all()
    assert (pairs[:, 1] >= kw["min_count"]).all()
    want = kmer.sample_only_kmers_plain(*args, **kw, device="cpu")
    assert sorted(zip(v.tolist(), pairs[:, 1].tolist())) == \
        sorted(zip(want[0].tolist(), want[1].tolist()))


@pytest.mark.cuda
def test_a_card_fault_ends_a_run(card, tmp_path):
    """A fault of the card (an index past a tensor's end, a device-side
    assert) raises an error of ``_build.DEVICE_FAULTS`` in its process,
    which the region isolation re-raises."""
    import subprocess
    import sys

    script = tmp_path / "fault.py"
    script.write_text(
        "import torch\n"
        "from breakmer_tpu_torch import _build\n"
        "x = torch.zeros(4, device='cuda')\n"
        "try:\n"
        "    x[torch.tensor([10], device='cuda')] = 1\n"
        "    torch.cuda.synchronize()\n"
        "except Exception as exc:\n"
        "    print(type(exc).__name__, isinstance(exc, _build.DEVICE_FAULTS))\n")
    from pathlib import Path

    root = Path(kmer.__file__).resolve().parents[2]
    proc = subprocess.run([sys.executable, str(script)], cwd=root, capture_output=True,
                          text=True, timeout=120, env={**__import__("os").environ,
                                                       "PYTHONPATH": str(root)})
    assert proc.stdout.split() == ["AcceleratorError", "True"], proc.stdout + proc.stderr


# -- the k-mer engine over its input domain (k <= 0 among it) ------------------

from breakmer_tpu_torch.testing import kmer_domain  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("k", kmer_domain.KS)
def test_kmer_domain_on_card_matches_plain(card, k):
    """Every variant of the domain grid at k through K1, K2 in both forms,
    the per-function route, the region kernel (K5) at each cluster size
    that takes it and the plan's route, exact against the plain versions
    on the card, each launch counted (``kmer_domain.held_on_card``); at k
    <= 0 the region kernel runs at every cluster size the card has."""
    for name in kmer_domain.cases():
        if name.startswith(f"k={k}/"):
            made = kmer_domain.held_on_card(name, card)
            if k <= 0 and made["per_function"]:
                assert made["clusters"] == list(kmer_cuda.cluster_sizes(card)), (name, made)


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True], ids=["serial", "batched"])
def test_run_at_k_0_on_card_matches_cpu(card, batched, tmp_path):
    """Scenario seed 1 (two genes, a matched normal) at kmer_size =
    seed_kmer_size = 0 through the runner on the card, serial (the region
    kernel a region) and batched (K1-K4): svs.out, the VCF and the ledger
    rows equal the CPU run's, no region error."""
    import json

    from breakmer_tpu_torch.config import Config
    from breakmer_tpu_torch.runner import Runner
    from breakmer_tpu_torch.testing.scenarios import build_scenario

    cfg_kwargs, _ = build_scenario(1, tmp_path, n_genes=2, kinds=["ins", "del"],
                                   with_normal_germline=True)
    cfg_kwargs.pop("reference_data_dir")
    out = {}
    for device in ("cpu", "cuda"):
        adir = tmp_path / device
        before, routes = dict(kmer_cuda.LAUNCHES), dict(kmer.ROUTES)
        runner = Runner(Config(**{**cfg_kwargs, "kmer_size": 0, "seed_kmer_size": 0,
                                  "batch_regions": batched, "analysis_dir": str(adir),
                                  "device": device, "log_level": "WARNING"}))
        runner.setup()
        runner.run()
        ledger = json.loads((adir / "ledger.json").read_text())
        assert json.loads((adir / "metrics.json").read_text())["errors"] == {}, device
        out[device] = ((adir / "output" / "prop_svs.out").read_bytes(),
                       (adir / "output" / "prop.vcf").read_bytes(),
                       {n: (e["rows"], e["vcf"], e["error"]) for n, e in ledger.items()})
        moved = {n: kmer_cuda.LAUNCHES[n] - before[n] for n in before}
    assert out["cuda"] == out["cpu"]
    if batched:
        assert all(moved[n] > 0 for n in kmer_cuda.KERNELS), moved
    else:
        assert moved["region_kmers"] == kmer.ROUTES["fused"] - routes["fused"] > 0, moved


# -- the SW engine over its input domain (signed and large parameters) --------

from breakmer_tpu_torch.testing import sw_domain  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("params", list(dict.fromkeys(
    name.split("/")[0] for name in sw_domain.cases(card=True))))
def test_sw_domain_on_card_matches_plain(card, params):
    """Every case of the SW domain grid at one parameter set, the wide ones
    too, through the kernel at the plan's form, R, pack and no_n, at every R
    forced, packed and unpacked, exact against the plain version on the
    card, each launch counted by form; refused before any launch only past
    the TPU kernel's score limit and at Lq = 0 (``sw_domain.held_on_card``)."""
    for name in sw_domain.cases(card=True):
        if name.split("/")[0] == params:
            made = sw_domain.held_on_card(name, card)
            B, Lq, Lt = (sw_domain.VARIANTS | sw_domain.WIDE_VARIANTS)[name.split("/")[1]][:3]
            p = sw_domain.case(name)["params"]
            assert made["refused"] == (Lq == 0 or p.match * min(Lq, Lt) >= 2**28), name
            assert made["refused"] or (made["ticket"] + made["block"] > 0) == (B * Lt > 0), name


@pytest.mark.cuda
def test_sw_code_below_0_under_no_n_scores_as_a_pad(card):
    """The no_n form's one deliberate divergence: codes below 0 (which
    realign never asserts no_n for) score as pads, -mismatch against every
    code; the plain version on those codes made codes that match nothing
    gives the card's answer, and on the codes themselves another."""
    c = sw_domain.case("default/negative_codes")
    q, t = (torch.from_numpy(c[k]).to(card) for k in ("q", "t"))
    qa, ta = torch.where(q < 0, -2, q).to(torch.int8), torch.where(t < 0, -3, t).to(torch.int8)
    for R in (None, *sw_cuda.BLOCK_ROWS_PER_LANE, *sw_cuda.ROWS_PER_LANE):
        for unpacked in (False, True):
            got = sw_cuda.sw_score_cuda(q, t, no_n=True, rows_per_lane=R, unpacked=unpacked)
            for a, b in zip(sw_score(qa, ta), got):
                assert torch.equal(a, b), (R, unpacked)
            assert not all(torch.equal(a, b) for a, b in zip(sw_score(q, t), got))
            for a, b in zip(sw_score(q, t), sw_cuda.sw_score_cuda(q, t, rows_per_lane=R,
                                                                  unpacked=unpacked)):
                assert torch.equal(a, b), (R, unpacked, "generic form")


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True], ids=["serial", "batched"])
def test_run_at_ungapped_penalties_on_card_matches_cpu(card, batched, tmp_path):
    """Scenario seed 1 (two genes, a matched normal) at gap_open_pen =
    gap_extend_pen = 1,000,000, which the parent refused on the card, through
    the runner: svs.out, the VCF and the ledger rows equal the CPU run's,
    no region error, the SW kernel launched."""
    import json

    from breakmer_tpu_torch.config import Config
    from breakmer_tpu_torch.runner import Runner
    from breakmer_tpu_torch.testing.scenarios import build_scenario

    cfg_kwargs, _ = build_scenario(1, tmp_path, n_genes=2, kinds=["ins", "del"],
                                   with_normal_germline=True)
    cfg_kwargs.pop("reference_data_dir")
    out = {}
    for device in ("cpu", "cuda"):
        adir = tmp_path / device
        before = sw_cuda.LAUNCHES
        runner = Runner(Config(**{**cfg_kwargs, "gap_open_pen": 1_000_000,
                                  "gap_extend_pen": 1_000_000, "batch_regions": batched,
                                  "analysis_dir": str(adir), "device": device,
                                  "log_level": "WARNING"}))
        runner.setup()
        runner.run()
        ledger = json.loads((adir / "ledger.json").read_text())
        assert json.loads((adir / "metrics.json").read_text())["errors"] == {}, device
        out[device] = ((adir / "output" / "prop_svs.out").read_bytes(),
                       (adir / "output" / "prop.vcf").read_bytes(),
                       {n: (e["rows"], e["vcf"], e["error"]) for n, e in ledger.items()})
        assert (sw_cuda.LAUNCHES > before) == (device == "cuda")
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
def test_germline_recheck_on_card_matches_cpu(card):
    """The germline recheck's candidate pass (K1 and a search of the seeds
    on the card), its one SW call a region and its verdicts, on the card
    against the CPU path: each case of the CPU tests alone, then every
    case of a seed as one region."""
    from breakmer_tpu_torch.call import germline
    from tests.test_torch_germline_recheck import CASES, IDENTITY, K, PARAMS, _batch, make_case

    def both(junctions, normal):
        got = []
        for device in ("cpu", card):
            counts = {}
            got.append((germline.find_carriers(junctions, normal, PARAMS, K, IDENTITY, device=device,
                                               counts=counts), counts))
        return got

    from breakmer_tpu_torch.ops import kmer_cuda

    sw_before, k1_before = sw_cuda.LAUNCHES, kmer_cuda.LAUNCHES["kmer_codes"]
    for seed in (1, 2):
        cases = [make_case(*c) for c in CASES if c[0] == seed]
        for contig, junction_q, reads, _ in cases:
            cpu, gpu = both([germline.junction_query(contig, junction_q, K)], _batch(reads))
            assert gpu == cpu
        region = [germline.junction_query(c, jq, K) for c, jq, _, _ in cases]
        cpu, gpu = both(region, _batch([r for _, _, rs, _ in cases for r in rs]))
        assert gpu == cpu and any(h is not None for h in gpu[0]) and gpu[1]["alignments"] > 0
    assert sw_cuda.LAUNCHES > sw_before and kmer_cuda.LAUNCHES["kmer_codes"] > k1_before
