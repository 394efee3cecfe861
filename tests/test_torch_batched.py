"""The batched panel path's device half: breakmer_tpu_torch.parallel
(``step._per_region_kmers`` over [G, ...], ``kmer_batch``, ``regions``)
against breakmer_tpu.parallel on the same numpy inputs from a seed. Every
output is an integer: tolerance 0, dtypes included (k-mer values and
packed words come back as np.uint32, counts as np.int32)."""

import functools
import json

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from breakmer_tpu.encode import PAD, ReadBatch, encode_seq
from breakmer_tpu.parallel import kmer_batch as jkb
from breakmer_tpu.parallel import regions as jreg
from breakmer_tpu.parallel.step import _per_region_kmers as jax_per_region_kmers
from breakmer_tpu_torch.parallel import kmer_batch as tkb
from breakmer_tpu_torch.parallel import regions as treg
from breakmer_tpu_torch.parallel.step import _per_region_kmers
from tests.fixtures import rand_seq

SENT = np.uint32(0xFFFFFFFF)


def _region_inputs(seed, G, R, L, Lref, Rn, Ln):
    """Per region a reference and reads tiled over a haplotype that
    carries a novel insertion, with ragged lengths and scattered N; the
    normal reads cover half of each insertion. Region 1 has an all-PAD
    normal; the last region is an empty padded slot (no reads, no ref)."""
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 4, (G, Lref)).astype(np.int8)
    ref_lengths = rng.integers(Lref * 3 // 4, Lref + 1, G).astype(np.int32)
    reads = np.full((G, R, L), PAD, np.int8)
    lengths = rng.integers(L // 2, L + 1, (G, R)).astype(np.int32)
    normal = np.full((G, Rn, Ln), PAD, np.int8)
    normal_lengths = np.full((G, Rn), Ln, np.int32)
    for g in range(G):
        at = int(rng.integers(0, Lref // 2))
        novel = rng.integers(0, 4, L).astype(np.int8)
        hap = np.concatenate([refs[g, :at], novel, refs[g, at:]])
        for r, s in enumerate(rng.integers(max(0, at - L), at + L // 2, R)):
            reads[g, r, :lengths[g, r]] = hap[s:s + lengths[g, r]]
        for r, s in enumerate(rng.integers(max(0, at - Ln), at, Rn)):
            normal[g, r] = hap[s:s + Ln]
    reads[rng.random(reads.shape) < 0.005] = PAD
    refs[np.arange(Lref)[None, :] >= ref_lengths[:, None]] = PAD
    normal[1], normal_lengths[1] = PAD, 0
    reads[-1], lengths[-1], refs[-1], ref_lengths[-1] = PAD, 0, PAD, 0
    return reads, lengths, refs, ref_lengths, normal, normal_lengths


@pytest.mark.parametrize("with_normal", [False, True])
@pytest.mark.parametrize("k,shape", [
    (9, dict(G=4, R=24, L=48, Lref=200, Rn=12, Ln=40)),
    (15, dict(G=3, R=40, L=100, Lref=400, Rn=16, Ln=80)),
])
def test_batched_region_kmers_match_jax_vmap(k, shape, with_normal):
    arrays = _region_inputs(k, **shape)
    if not with_normal:
        arrays = arrays[:4]
    jax_fn = jax.vmap(functools.partial(jax_per_region_kmers, k=k, min_count=2))
    want = [np.asarray(x) for x in jax_fn(*arrays)]
    values, counts = _per_region_kmers(*map(torch.from_numpy, arrays), k=k, min_count=2)
    got = [values.numpy().astype(np.uint32), counts.numpy()]
    for name, a, b in zip(("values", "counts"), want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    kept = (got[1] > 0).sum(axis=1)
    assert kept[0] > 0 and kept[-1] == 0  # k-mers survive; the empty slot has none
    assert np.all((got[0] == SENT) == (got[1] == 0))


def test_normal_subtracts_and_all_pad_normal_subtracts_nothing():
    arrays = [torch.from_numpy(a) for a in _region_inputs(15, 3, 40, 100, 400, 16, 80)]
    plain = _per_region_kmers(*arrays[:4], k=15, min_count=2)[1]
    with_normal = _per_region_kmers(*arrays, k=15, min_count=2)[1]
    kept = lambda c: (c > 0).sum(dim=1).tolist()  # noqa: E731
    assert kept(with_normal)[0] < kept(plain)[0]  # the normal removed k-mers
    assert torch.equal(with_normal[1], plain[1])  # region 1: all-PAD normal


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_region_kmers_are_one_set_of_ops_for_any_G():
    """No Python loop over regions: the op count does not grow with G."""
    counts = []
    for G in (2, 6):
        arrays = [torch.from_numpy(a) for a in _region_inputs(3, G, 8, 32, 64, 4, 32)]
        with _OpCount() as mode:
            _per_region_kmers(*arrays, k=9, min_count=2)
        counts.append(mode.n)
    assert counts[0] == counts[1] > 0


# ------------------------------------------------------------ packed fetch

def _rand_outputs(rng, G, K, frac_valid=0.02):
    """Random [G, K] k-mer step outputs: mostly sentinel padding (as in
    tests/test_parallel.py)."""
    values = np.full((G, K), SENT, dtype=np.uint32)
    counts = np.zeros((G, K), dtype=np.int32)
    for g in range(G):
        n = max(1, int(K * frac_valid))
        slots = rng.choice(K, size=n, replace=False)
        values[g, slots] = rng.choice(K * 4, size=n, replace=False).astype(np.uint32)
        counts[g, slots] = rng.integers(1, 50, size=n).astype(np.int32)
    return values, counts


class _FakeBatch:
    def __init__(self, names):
        self.names = names


def _compact_both(values, counts, cap):
    want = jax.jit(lambda v, c: jkb._compact_outputs(v, c, cap))(values, counts)
    got = tkb._compact_outputs(torch.from_numpy(values.astype(np.int64)),
                               torch.from_numpy(counts), cap)
    want = [np.asarray(want[0]), np.asarray(want[1]), int(want[2])]
    got = [got[0].numpy().astype(np.uint32), got[1].numpy().astype(np.uint32), int(got[2])]
    return want, got


@pytest.mark.parametrize("case", ["fits", "n_over_cap", "count_2_24"])
def test_compact_outputs_match_jax(case):
    rng = np.random.default_rng(7)
    G, K, cap = 6, 512, 6 * 64
    values, counts = _rand_outputs(rng, G, K)
    if case == "n_over_cap":
        values, counts = _rand_outputs(rng, 4, K, frac_valid=0.5)
        cap = 16
    elif case == "count_2_24":
        counts[2, np.flatnonzero(counts[2])[0]] = 1 << 24
    want, got = _compact_both(values, counts, cap)
    for name, a, b in zip(("vals", "gc"), want, got):
        assert a.dtype == b.dtype == np.uint32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[2] == want[2] == (int((counts > 0).sum()) if case == "fits" else -1)
    if case == "fits":
        batch = _FakeBatch([f"R{g}" if g != 3 else "" for g in range(G)])
        full = tkb._postprocess(batch, values, counts)
        packed = tkb._postprocess_packed(batch, *got)
        ref = jkb._postprocess(batch, values, counts)
        assert list(full) == list(packed) == list(ref)
        for name in ref:
            for a, b, c in zip(ref[name], full[name], packed[name]):
                assert a.dtype == b.dtype == c.dtype
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)


# ---------------------------------------------------------- region packing

def _regions(case):
    if case == "ragged":  # test_pack_region_batches's regions
        return [(f"G{i}", ReadBatch.from_seqs([rand_seq(i * 10 + j, 80)
                                               for j in range(10 + i)]),
                 encode_seq(rand_seq(1000 + i, 900))) for i in range(5)]
    if case == "tiers":  # test_pack_groups_by_tier's regions
        small = [(f"S{i}", ReadBatch.from_seqs(["ACGT" * 20] * 8),
                  encode_seq(rand_seq(i, 500))) for i in range(3)]
        return small + [("BIG", ReadBatch.from_seqs(["ACGT" * 60] * 600),
                         encode_seq(rand_seq(9, 7000)))]
    # a matched normal for some regions, none (None) for one
    out = []
    for i in range(4):
        ref = rand_seq(200 + i, 1200)
        reads = ReadBatch.from_seqs([ref[s:s + 100] for s in range(0, 1000, 9 + i)])
        normal = (None if i == 2 else
                  ReadBatch.from_seqs([ref[s:s + 90] for s in range(0, 1100, 13)]))
        out.append((f"N{i}", reads, encode_seq(ref), normal))
    return out


@pytest.mark.parametrize("case,rpb", [("ragged", 4), ("tiers", 8), ("normal", 3)])
def test_pack_region_batches_match_jax(case, rpb):
    regions = _regions(case)
    want = jreg.pack_region_batches(regions, regions_per_batch=rpb)
    got = treg.pack_region_batches(regions, regions_per_batch=rpb)
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        assert a.names == b.names and a.shape_key == b.shape_key
        for field in ("reads", "lengths", "nreads", "refs", "ref_lengths",
                      "normal_reads", "normal_lengths"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None), field
            if x is not None:
                assert x.dtype == y.dtype, field
                np.testing.assert_array_equal(x, y, err_msg=field)
    with_normal = case == "normal"
    for r in regions:
        normal = r[3] if with_normal else None
        assert (treg.tier_key(r[1], r[2], normal, with_normal)
                == jreg.tier_key(r[1], r[2], normal, with_normal))
    if case == "tiers":
        assert len({b.shape_key for b in got}) == 2


# ------------------------------------------------------ the k-mer batch step

def _kmer_regions():
    """Regions whose reads carry a novel insertion (sample-only k-mers at
    counts >= 2); a matched normal covering one of the insertions."""
    out = []
    for i in range(5):
        ref = rand_seq(300 + i, 900 + 150 * i)
        novel = rand_seq(400 + i, 60)
        hap = ref[:400] + novel + ref[400:]
        reads = ReadBatch.from_seqs([hap[s:s + 90] for s in range(200, 560, 6 + i)])
        normal = ReadBatch.from_seqs([(hap if i == 1 else ref)[s:s + 90]
                                      for s in range(250, 600, 11)])
        out.append((f"K{i}", reads, encode_seq(ref), normal))
    return out


def _assert_same_kmers(want, got):
    assert list(got) == list(want) and len(want) > 0
    for name in want:
        for a, b in zip(want[name], got[name]):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("form", ["pipeline", "batches", "overflow"])
def test_kmer_batch_matches_jax(form, monkeypatch):
    regions = _kmer_regions()
    k, rpb = 15, 2
    if form == "overflow":
        monkeypatch.setattr(tkb, "_PACK_SLOTS_PER_REGION", 1)
    if form == "batches":
        want = jkb.run_kmer_batches(jreg.pack_region_batches(regions, rpb), k)
        got = tkb.run_kmer_batches(treg.pack_region_batches(regions, rpb), k,
                                   device="cpu")
    else:
        jax_kb = jkb.KmerBatchPipeline(k, regions_per_batch=rpb)
        kb = tkb.KmerBatchPipeline(k, regions_per_batch=rpb, device="cpu")
        for r in regions:
            jax_kb.add(*r)
            kb.add(*r)
        want, got = jax_kb.finish(), kb.finish()
        assert kb.dispatched == 3
        assert kb.refetched == (3 if form == "overflow" else 0)
    _assert_same_kmers(want, got)
    assert sum(len(v) for v, _ in got.values()) > 0
    assert len(got["K1"][0]) < len(got["K0"][0])  # K1's normal removed its k-mers


@pytest.mark.parametrize("entry", ["KmerBatchPipeline", "run_kmer_batch",
                                   "run_kmer_batches"])
def test_kmer_batch_sharded_form_is_not_ported(entry):
    batch = treg.pack_region_batches(_kmer_regions()[:1], 1)[0]
    calls = {
        "KmerBatchPipeline": lambda: tkb.KmerBatchPipeline(15, mesh=object(), device="cpu"),
        "run_kmer_batch": lambda: tkb.run_kmer_batch(batch, 15, 2, object(), device="cpu"),
        "run_kmer_batches": lambda: tkb.run_kmer_batches([batch], 15, 2, object(),
                                                         device="cpu"),
    }
    with pytest.raises(NotImplementedError, match="Queue 1, item 2"):
        calls[entry]()


# ------------------------------------------- the batched runner end to end

from breakmer_tpu.config import Config  # noqa: E402
from breakmer_tpu.runner import Runner as JaxRunner  # noqa: E402
from breakmer_tpu_torch.runner import Runner as TorchRunner  # noqa: E402
from tests.scenarios import build_scenario  # noqa: E402
from tests.test_property_e2e import _CI_KINDS  # noqa: E402


@pytest.fixture(scope="module")
def panel_run(tmp_path_factory):
    """panel_run(seed, package, **knobs) -> (events, outputs, runner) of
    one run on scenario ``seed`` (normal germline, a two-SV gene), on the
    CPU; each (seed, package, knobs) runs once per module."""
    scenarios, done = {}, {}

    def run(seed, package, **knobs):
        key = (seed, package, tuple(sorted(knobs.items())))
        if key not in done:
            if seed not in scenarios:
                work = tmp_path_factory.mktemp(f"seed{seed}")
                cfg_kwargs, checks = build_scenario(
                    seed, work, n_genes=4, kinds=_CI_KINDS[seed],
                    with_normal_germline=True, multi_sv_gene=True)
                cfg_kwargs.pop("reference_data_dir")  # each run builds its own
                scenarios[seed] = (work, cfg_kwargs, checks)
            work, cfg_kwargs, _ = scenarios[seed]
            out = work / f"{package}_{len(done)}"
            cfg = Config(**{**cfg_kwargs, **knobs, "analysis_dir": str(out),
                            "device": "cpu", "log_level": "WARNING"})
            runner = {"jax": JaxRunner, "torch": TorchRunner}[package](cfg)
            runner.setup()
            events = runner.run()
            ledger = json.loads((out / "ledger.json").read_text())
            done[key] = (events, {
                "svs": (out / "output" / "prop_svs.out").read_bytes(),
                "vcf": (out / "output" / "prop.vcf").read_bytes(),
                "ledger": {n: (e["rows"], e["vcf"], e["error"]) for n, e in ledger.items()},
                "stats": {n: e["stats"] for n, e in ledger.items()},
            }, runner)
        return done[key]

    run.checks = lambda seed: scenarios[seed][2]
    return run


def _assert_same_output(ref, got, stats=True):
    assert got["svs"] == ref["svs"]
    assert got["vcf"] == ref["vcf"]
    assert got["ledger"] == ref["ledger"]
    assert all(err is None for _, _, err in got["ledger"].values())
    if stats:
        assert got["stats"] == ref["stats"]


@pytest.mark.parametrize("seed", [1, 7])
def test_batched_port_matches_jax_batched_and_port_serial(seed, panel_run):
    _, jax_batched, _ = panel_run(seed, "jax", batch_regions=True)
    events, batched, runner = panel_run(seed, "torch", batch_regions=True)
    _, serial, _ = panel_run(seed, "torch", batch_regions=False)
    _assert_same_output(jax_batched, batched)
    _assert_same_output(serial, batched, stats=False)
    assert batched["svs"].count(b"\n") > 1  # calls were made
    assert runner.kmer_pipeline.dispatched > 0
    for gene, (kind, check) in panel_run.checks(seed).items():
        evs = [e for e in events if e.genes.split(",")[0] == gene]
        assert not check(evs), f"seed {seed} {gene} ({kind})"


@pytest.mark.parametrize("knobs", [dict(nprocs=4), dict(kmer_regions_per_batch=1)],
                         ids=["nprocs4", "rpb1"])
def test_batched_knobs_give_the_same_output(knobs, panel_run):
    """nprocs (host worker threads) and kmer_regions_per_batch (launch
    packing) schedule work only: svs.out, VCF, ledger rows and stats are
    those of nprocs=1 at kmer_regions_per_batch=32."""
    _, ref, ref_runner = panel_run(1, "torch", batch_regions=True)
    _, got, runner = panel_run(1, "torch", batch_regions=True, **knobs)
    assert ref_runner.cfg.nprocs == 1 and ref_runner.cfg.kmer_regions_per_batch == 32
    _assert_same_output(ref, got)
    if "kmer_regions_per_batch" in knobs:
        assert runner.kmer_pipeline.dispatched > ref_runner.kmer_pipeline.dispatched


def test_batched_packed_overflow_matches_serial(panel_run, monkeypatch):
    """One slot a region: a packed fetch with more sample-only k-mers
    than regions overflows and takes the full-shape refetch; the output
    is still the serial path's."""
    monkeypatch.setattr(tkb, "_PACK_SLOTS_PER_REGION", 1)
    _, got, runner = panel_run(1, "torch", batch_regions=True, nprocs=2)
    _, serial, _ = panel_run(1, "torch", batch_regions=False)
    _assert_same_output(serial, got, stats=False)
    kb = runner.kmer_pipeline
    assert 0 < kb.refetched <= kb.dispatched


# ------------------------------------------------------------ the panel bench

def test_bench_panel_builds_the_jax_benchs_panel(tmp_path):
    import bench_panel as jax_bench_panel
    from breakmer_tpu_torch import bench_panel

    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = jax_bench_panel.build_panel(tmp_path / "jax", 3, 6, 2)
    got = bench_panel.build_panel(tmp_path / "torch", 3, 6, 2, device="cpu")
    for name in ("genome.fa", "targets.bed", "sample.sam"):
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert got.batch_regions and got.nprocs == want.nprocs == 2 and got.device == "cpu"


def test_bench_panel_prints_one_line_on_the_cpu(capsys):
    from breakmer_tpu_torch import bench_panel

    bench_panel.main(["2", "6", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["platform"] == "cpu" and "card" not in line and line["value"] > 0
    d = line["detail"]
    assert d["n_genes"] == 2 and d["calls"] >= 1 and d["kmer_launches"] >= 1
    assert set(d["stage_s"]) >= {"kmer_device", "assemble", "realign", "classify"}


def test_bench_panel_needs_a_card_unless_cpu(monkeypatch):
    from breakmer_tpu_torch import bench_panel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        bench_panel.main([])


def test_bench_panel_cpu_gate_needs_its_baseline(tmp_path, monkeypatch, capsys):
    from types import SimpleNamespace

    from breakmer_tpu_torch import bench_panel

    monkeypatch.setattr(bench_panel, "CPU_BASELINE", tmp_path / "base.json")
    monkeypatch.setattr(bench_panel, "build_panel", lambda work, *a, **kw:
                        SimpleNamespace(analysis_dir=str(work / "analysis")))
    monkeypatch.setattr(bench_panel, "run_once", lambda cfg: {
        "elapsed_s": 0.5, "targets": 10, "calls": 3})
    for argv, code in ((["--cpu-check"], 2), (["--cpu-update"], 0), (["--cpu-check"], 0)):
        with pytest.raises(SystemExit) as exc:
            bench_panel.main(argv)
        assert exc.value.code == code, argv
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert out[0]["ok"] is False and "missing" in out[0]["error"]
    assert out[2]["ok"] is True and out[2]["drift_vs_baseline"] == {"20g": 1.0, "100g": 1.0}
