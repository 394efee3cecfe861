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


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lt,pattern", [
    (37, 128, 256, None), (5, 1024, 2048, None), (3, 300, 40, None), (2, 10240, 512, None),
    *[(B, Lq, Lt, None) for B, Lq, Lt in _EDGES],            # strip edges, every R
    (4, 1, 50, None), (4, 50, 1, None), (2, 1, 1, None), (5, 20, 64, None),  # Lq, Lt tiny
    (1, 256, 512, None), (131, 256, 512, None), (133, 256, 512, None),  # B across the SMs
    (9, 200, 333, (0, 1)), (9, 300, 200, (0,)), (7, 600, 700, (0, 1, 2)),  # ties
    (2, 10240, 2048, None),                                  # a long query, many strips
])
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
        assert not sw_cuda.launch_plan(B, Lq, Lt, match=params.match).pack
        q, t = (torch.from_numpy(a).to(card) for a in _codes(rng, B, Lq, Lt, 0.0, pattern))
        ref = sw_score(q, t, params)
        assert int(ref[0].max()) >= 2 ** 15
        for R in (None, *sw_cuda.ROWS_PER_LANE):
            got = sw_cuda.sw_score_cuda(q, t, params, no_n=no_n, rows_per_lane=R)
            for name, a, b in zip(("score", "q_end", "t_end"), ref, got):
                assert torch.equal(a, b), f"{name} no_n={no_n} {params} R={R}"


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
_KMER_SHAPES = [(200, 100), (1, 3000), (1, 60), (32 * 512, 128), (5, 15), (3, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 11, 15])
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
@pytest.mark.parametrize("k", [1, 5, 11, 15])
def test_revcomp_kernel_matches_plain(card, k):
    rng = np.random.default_rng(k)
    codes, lengths = (torch.from_numpy(a).to(card) for a in _read_codes(rng, 64, 200, k))
    km = kmer.kmer_codes_plain(codes, lengths, k)[0]
    for x in (km, km.reshape(-1), km[:, ::3], km.t(),
              torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, 999)).to(card)):
        _equal(kmer.revcomp_kmers_plain(x, k),
               _launched("revcomp_kmers", lambda: kmer.revcomp_kmers(x, k)))


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
    # a table of width 0 finds nothing (the plain version indexes past it)
    v, c = v32[:2], c32[:2]
    empty = torch.empty((2, 0), dtype=torch.int64, device=card)
    got = _launched("subtract_sorted", lambda: kmer.subtract_sorted(v, c, empty, empty))
    _equal((v, c), got)


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
        before = dict(kmer_cuda.LAUNCHES)
        got = kmer.sample_only_kmers(*args, **kw, device=card)
        moved = {n: kmer_cuda.LAUNCHES[n] - before[n] for n in before}
        want = kmer.sample_only_kmers(*args, **kw, device="cpu")
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        sample = name != "empty_batch"  # an empty batch launches nothing for the sample
        assert moved == {"kmer_codes": 1 + sample + with_normal, "revcomp_kmers": 1,
                         "unique_counts_sorted": sample, "subtract_sorted": sample}, name
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
                     "subtract_sorted": 1}
    _equal(tuple(want), tuple(g.cpu() for g in got))
    assert int((want[1] > 0).sum()) > 0
