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


# -- the probe kernels and the region step (every comparison exact) --------

from breakmer_tpu_torch.parallel.step import make_region_step, to_numpy  # noqa: E402
from breakmer_tpu_torch.tools import probe_mosaic_cummax as cm  # noqa: E402
from breakmer_tpu_torch.tools import probe_swar_i16 as i16  # noqa: E402
from breakmer_tpu_torch.tools import probe_swar_i16b as i16b  # noqa: E402
from breakmer_tpu_torch.tools import sw_ceiling_probe as ceil  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("do_rolls", [True, False])
@pytest.mark.parametrize("steps", [0, 1, 7, 255, None])
def test_ceiling_probe_kernel_matches_plain(card, do_rolls, steps):
    q, t = ceil.inputs(card)
    before = ceil.LAUNCHES
    got = ceil.stripped(q, t, do_rolls, steps)
    torch.cuda.synchronize()
    assert ceil.LAUNCHES == before + 1
    assert torch.equal(got, ceil.stripped_plain(q, t, do_rolls, steps))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lt", [(3, 300, 400), (5, 33, 33), (1, 1, 2)])
def test_ceiling_probe_kernel_other_shapes(card, B, Lq, Lt):
    rng = np.random.default_rng(Lq)
    q = torch.from_numpy(rng.integers(-50, 50, (B, Lq)).astype(np.int8)).to(card)
    t = torch.from_numpy(rng.integers(-50, 50, (B, Lt)).astype(np.int8)).to(card)
    for do_rolls in (True, False):
        for steps in (1, 5, Lq - 1, Lq + 3):
            assert torch.equal(ceil.stripped(q, t, do_rolls, steps),
                               ceil.stripped_plain(q, t, do_rolls, steps))


@pytest.mark.cuda
@pytest.mark.parametrize("mod", [i16, i16b], ids=["i16", "i16b"])
def test_probe_i16_ops_match_plain(card, mod):
    before = mod.LAUNCHES
    rows = mod.run_ops(mod.OPS, mod.run_op, mod.inputs(), card)
    assert [r["name"] for r in rows if not r["exact"]] == []
    assert mod.LAUNCHES > before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 256), (4, 1024), (2, 33)])
def test_probe_i16_ops_wrap_like_numpy(card, shape):
    """Full-range int16 inputs: every op wraps as the plain int16 torch op
    does. The indicator op is left out: the kernel's compare equals the
    probe's indicator arithmetic only while |h - bh| < 2^15."""
    rng = np.random.default_rng(shape[1])
    full = lambda: rng.integers(-32768, 32768, shape).astype(np.int16)  # noqa: E731
    arrays = {"A": full(), "B": full(), "H": full(), "BH": full(), "BD": full(),
              "M": rng.integers(0, 2, shape).astype(np.int16) * -1,
              "ONEHOT": np.where(np.arange(shape[1]) == 0, -1, 0).astype(np.int16)
              * np.ones(shape, np.int16),
              "Q32": rng.integers(0, 5, shape).astype(np.int32),
              "T32": rng.integers(0, 5, shape).astype(np.int32)}
    arrays["A32"] = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    ops = [op for op in i16.OPS + i16b.OPS if op.name != "indicator-select (bd update)"]
    rows = i16.run_ops(ops, i16.run_op, arrays, card)
    assert [r["name"] for r in rows if not r["exact"]] == []


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 256), (5, 1000), (3, 33), (1, 1), (2, 1024)])
def test_cummax_kernel_matches_plain(card, shape):
    rng = np.random.default_rng(shape[1])
    x = torch.from_numpy(rng.integers(-2**31, 2**31, shape).astype(np.int32)).to(card)
    before = cm.LAUNCHES
    got = cm.cummax(x)
    torch.cuda.synchronize()
    assert cm.LAUNCHES == before + 1
    assert torch.equal(got, cm.cummax_plain(x))


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
    from tests.scenarios import build_scenario

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
    from breakmer_tpu.encode import ReadBatch, encode_seq
    from tests.fixtures import rand_seq

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

    from breakmer_tpu.utils.meter import METER
    from breakmer_tpu_torch.cli import main
    from tests.scenarios import build_scenario

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
