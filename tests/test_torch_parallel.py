"""The multi-device forms of breakmer_tpu_torch.parallel on a virtual mesh
of CPU devices, against breakmer_tpu.parallel on its 8 virtual CPU
devices (tests/conftest.py) and against the port's unsharded forms, on
the same numpy inputs from a seed: the mesh, the sharded region step,
the k-mer batch step sharded over the regions axis, and the batched
runner over a mesh of ``device.local_devices``. Every output is an
integer or a file: tolerance 0, dtypes included."""

import json
import shutil
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from breakmer_tpu import encode as jenc
from breakmer_tpu.parallel import kmer_batch as jkb
from breakmer_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from breakmer_tpu.parallel import make_region_step as jax_region_step
from breakmer_tpu.parallel import regions as jreg
from breakmer_tpu.parallel.mesh import _factor_2d as jax_factor_2d
from breakmer_tpu_torch import device as tdevice
from breakmer_tpu_torch import encode as tenc
from breakmer_tpu_torch.parallel import kmer_batch as tkb
from breakmer_tpu_torch.parallel import regions as treg
from breakmer_tpu_torch.parallel import step as tstep
from breakmer_tpu_torch.parallel.mesh import _factor_2d, make_mesh_2d, mesh_axes
from breakmer_tpu_torch.parallel.step import make_region_step, to_numpy
from tests.test_parallel import _tiny_inputs
from tests.test_torch_batched import _assert_same_kmers, _kmer_regions

CPU = torch.device("cpu")


def cpus(n):
    return [CPU] * n


# ------------------------------------------------------------------ the mesh

@pytest.mark.parametrize("n", range(1, 17))
def test_factor_2d_matches_jax(n):
    assert _factor_2d(n) == jax_factor_2d(n)


def test_virtual_mesh_has_the_jax_shape_and_axes():
    mesh = make_mesh_2d(devices=cpus(8))
    jax_mesh = jax_make_mesh_2d()
    assert mesh.devices.shape == jax_mesh.devices.shape == (4, 2)
    assert mesh.axis_names == tuple(jax_mesh.axis_names) == mesh_axes()
    assert all(d == CPU for d in mesh.devices.flat) and mesh.first == CPU
    assert make_mesh_2d(n_devices=6, devices=cpus(8)).devices.shape == (3, 2)
    with pytest.raises(ValueError, match="n_devices=9"):
        make_mesh_2d(n_devices=9, devices=cpus(8))


def test_mesh_and_local_devices_have_no_fallback(monkeypatch):
    assert tdevice.local_devices("cpu") == [CPU]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert tdevice.local_devices("cuda") == [torch.device("cuda", i) for i in range(3)]
    assert tdevice.local_devices("auto") == tdevice.local_devices("cuda")
    assert tdevice.local_devices("cuda:2") == [torch.device("cuda", 2)]
    assert make_mesh_2d().devices.shape == (3, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        make_mesh_2d()  # every visible card by default: none here


# ---------------------------------------------------------- the region step

def _step_inputs(name):
    if name == "tiny":  # tests/test_parallel.py's inputs
        return _tiny_inputs(), 9
    return graft._example_inputs(G=8, B=8), 15  # __graft_entry__'s, at G = B = 8


_JAX_STEPS = {}


def _jax_sharded(name):
    if name not in _JAX_STEPS:
        inputs, k = _step_inputs(name)
        out = jax_region_step(mesh=jax_make_mesh_2d(), k=k)(*inputs)
        _JAX_STEPS[name] = [np.asarray(x) for x in out]
    return _JAX_STEPS[name]


@pytest.mark.parametrize("n_devices", [8, 2], ids=["mesh4x2", "mesh2x1"])
@pytest.mark.parametrize("name", ["tiny", "example"])
def test_sharded_region_step_matches_jax_and_unsharded(name, n_devices):
    inputs, k = _step_inputs(name)
    want = _jax_sharded(name)
    tensors = [torch.from_numpy(a) for a in inputs]
    single = to_numpy(make_region_step(mesh=None, k=k)(*tensors))
    mesh = make_mesh_2d(devices=cpus(n_devices))
    got = to_numpy(make_region_step(mesh=mesh, k=k)(*tensors))
    for field, a, b, c in zip(("values", "counts", "scores", "q_end", "t_end"),
                              want, got, single):
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
        np.testing.assert_array_equal(b, c, err_msg=field)
    if name == "tiny":
        assert (got[2][:, 0] == 32).all()  # pair 0 of every region: 16 bp exact


def test_sharded_region_step_scores_each_shard_once(monkeypatch):
    """One SW call a shard a step, on the shard's block: regions block i,
    pairs block j, in mesh order."""
    calls = []
    orig = tstep.sw_score_auto

    def record(q, t, params):
        calls.append((q.clone(), t.clone()))
        return orig(q, t, params)

    monkeypatch.setattr(tstep, "sw_score_auto", record)
    inputs, k = _step_inputs("tiny")
    q = inputs[4]
    make_region_step(mesh=make_mesh_2d(devices=cpus(8)), k=k)(*map(torch.from_numpy, inputs))
    assert len(calls) == 8
    for n, (cq, _) in enumerate(calls):
        i, j = divmod(n, 2)
        block = q[2 * i:2 * i + 2, 4 * j:4 * j + 4]
        np.testing.assert_array_equal(cq.numpy(), block.reshape(8, -1))


@pytest.mark.parametrize("G,B", [(6, 8), (8, 7)], ids=["G_uneven", "B_uneven"])
def test_sharded_region_step_needs_even_blocks(G, B):
    inputs = [torch.from_numpy(a) for a in _tiny_inputs(G=G, B=B)]
    step = make_region_step(mesh=make_mesh_2d(devices=cpus(8)), k=9)
    with pytest.raises(ValueError, match="does not split evenly"):
        step(*inputs)


# ----------------------------------------------- the sharded k-mer batch step

def _regions_of(enc, with_normal):
    regions = _kmer_regions(enc)
    return regions if with_normal else [r[:3] for r in regions]


@pytest.mark.parametrize("overflow", [False, True], ids=["packed", "overflow"])
@pytest.mark.parametrize("with_normal", [True, False], ids=["normal", "no_normal"])
@pytest.mark.parametrize("form", ["pipeline", "batches"])
def test_sharded_kmer_batch_matches_jax_mesh_and_unsharded(form, with_normal, overflow,
                                                           monkeypatch):
    regions, jax_regions = _regions_of(tenc, with_normal), _regions_of(jenc, with_normal)
    k, rpb = 15, 4
    if overflow:
        monkeypatch.setattr(tkb, "_PACK_SLOTS_PER_REGION", 1)
        monkeypatch.setattr(jkb, "_PACK_SLOTS_PER_REGION", 1)
    mesh, jax_mesh = make_mesh_2d(devices=cpus(8)), jax_make_mesh_2d()
    if form == "batches":
        want = jkb.run_kmer_batches(jreg.pack_region_batches(jax_regions, rpb), k, 2, jax_mesh)
        batches = treg.pack_region_batches(regions, rpb)
        got = tkb.run_kmer_batches(batches, k, 2, mesh)
        single = tkb.run_kmer_batches(batches, k, 2, device="cpu")
    else:
        jax_kb = jkb.KmerBatchPipeline(k, mesh=jax_mesh, regions_per_batch=rpb)
        kb = tkb.KmerBatchPipeline(k, mesh=mesh, regions_per_batch=rpb)
        one = tkb.KmerBatchPipeline(k, regions_per_batch=rpb, device="cpu")
        for jr, r in zip(jax_regions, regions):
            jax_kb.add(*jr)
            kb.add(*r)
            one.add(*r)
        want, got, single = jax_kb.finish(), kb.finish(), one.finish()
        assert kb.dispatched == one.dispatched == 2
        assert kb.refetched == one.refetched == (2 if overflow else 0)
    _assert_same_kmers(want, got)
    _assert_same_kmers(single, got)
    assert (len(got["K1"][0]) < len(got["K0"][0])) == with_normal


def test_sharded_kmer_batch_needs_even_blocks():
    batch = treg.pack_region_batches(_kmer_regions()[:3], 3)[0]
    with pytest.raises(ValueError, match="does not split evenly"):
        tkb.run_kmer_batch(batch, 15, 2, make_mesh_2d(devices=cpus(2)))
    with pytest.raises(ValueError, match="exactly one of device and mesh"):
        tkb.KmerBatchPipeline(15, mesh=make_mesh_2d(devices=cpus(2)), device="cpu")


# -------------------------------------------- the batched runner over a mesh

from breakmer_tpu.config import Config as JaxConfig  # noqa: E402
from breakmer_tpu.runner import Runner as JaxRunner  # noqa: E402
from breakmer_tpu_torch.config import Config as TorchConfig  # noqa: E402
from breakmer_tpu_torch.parallel.index_shard import ShardedGenomeIndex  # noqa: E402
from breakmer_tpu_torch.runner import Runner as TorchRunner  # noqa: E402
from tests.scenarios import build_scenario  # noqa: E402
from tests.test_property_e2e import _CI_KINDS  # noqa: E402


def _dryrun_panel(work: Path):
    """``__graft_entry__._dryrun_full_panel``'s panel (four targets: an
    insertion, a deletion, a translocation, a reference region) written
    under ``work``; its Config keyword arguments."""
    from tests.fixtures import (ErrorModel, Haplotype, NovelBlock, RefBlock, SamBuilder,
                                rand_seq)
    from breakmer_tpu.io.fasta import write_fasta

    genome = {"chr1": rand_seq(31, 9000), "chr2": rand_seq(32, 6000)}
    write_fasta(work / "genome.fa", genome)
    (work / "targets.bed").write_text(
        "chr1\t1000\t1600\tDRY_INS\nchr1\t3000\t3800\tDRY_DEL\n"
        "chr1\t5000\t5600\tDRY_TRL\nchr1\t7000\t7500\tDRY_REF\n")
    sam = SamBuilder(genome, error_model=ErrorModel(), error_seed=17)
    sam.add_haplotype_reads(Haplotype(genome, [
        RefBlock("chr1", 1000, 1300), NovelBlock("TTGACCATGGATCCGGTACAT"),
        RefBlock("chr1", 1300, 1600)]), 180, 440, prefix="di")
    sam.add_haplotype_reads(Haplotype(genome, [
        RefBlock("chr1", 3000, 3400), RefBlock("chr1", 3460, 3800)]), 180, 620, prefix="dd")
    sam.add_haplotype_reads(Haplotype(genome, [
        RefBlock("chr1", 5000, 5300), RefBlock("chr2", 3000, 3400)]), 180, 420, prefix="dt")
    sam.add_discordant_pairs("chr1", 5300, "chr2", 3000, n=5)
    for s, e in ((1000, 1600), (3000, 3800), (5000, 5600), (7000, 7500)):
        sam.add_background_pairs("chr1", s - 200, e + 200, prefix=f"bg{s}")
    sam.write(work / "sample.sam")
    return dict(analysis_name="prop", targets_bed_file=str(work / "targets.bed"),
                reference_fasta=str(work / "genome.fa"),
                sample_bam_file=str(work / "sample.sam"), kmer_size=15, indel_size=15,
                indel_sr_thresh=2, rearr_sr_thresh=2, trl_sr_thresh=2)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """mesh_run(panel, package, n_local, **knobs) -> (outputs, runner) of
    one CPU run on ``panel`` (scenario seed 1 or 7, or "dryrun"), the
    port's with ``device.local_devices`` giving ``n_local`` CPU devices;
    each combination runs once per module."""
    panels, done = {}, {}

    def run(panel, package, n_local=1, **knobs):
        key = (panel, package, n_local, tuple(sorted(knobs.items())))
        if key not in done:
            if panel not in panels:
                work = tmp_path_factory.mktemp(f"panel_{panel}")
                if panel == "dryrun":
                    panels[panel] = _dryrun_panel(work)
                else:
                    cfg_kwargs, _ = build_scenario(
                        panel, work, n_genes=4, kinds=_CI_KINDS[panel],
                        with_normal_germline=True, multi_sv_gene=True)
                    cfg_kwargs.pop("reference_data_dir")
                    panels[panel] = cfg_kwargs
            cfg_kwargs = panels[panel]
            out = Path(cfg_kwargs["targets_bed_file"]).parent / f"{package}_{len(done)}"
            config, runner_cls = {"jax": (JaxConfig, JaxRunner),
                                  "torch": (TorchConfig, TorchRunner)}[package]
            runner = runner_cls(config(**{**cfg_kwargs, **knobs, "analysis_dir": str(out),
                                          "device": "cpu", "log_level": "WARNING"}))
            with mock.patch.object(tdevice, "local_devices",
                                   lambda device="auto": cpus(n_local)):
                runner.setup()
                runner.run()
            ledger = json.loads((out / "ledger.json").read_text())
            done[key] = ({
                "svs": (out / "output" / "prop_svs.out").read_bytes(),
                "vcf": (out / "output" / "prop.vcf").read_bytes(),
                "ledger": {n: (e["rows"], e["vcf"], e["error"]) for n, e in ledger.items()},
            }, runner)
            shutil.rmtree(out)
        return done[key]

    return run


def _assert_same(ref, got):
    assert got == ref
    assert got["svs"].count(b"\n") > 1  # calls were made
    assert all(err is None for _, _, err in got["ledger"].values())


@pytest.mark.parametrize("panel", [1, 7, "dryrun"])
def test_batched_runner_over_a_mesh_matches_jax_batched_and_port_serial(panel, mesh_run):
    jax_batched, _ = mesh_run(panel, "jax", batch_regions=True)
    serial, _ = mesh_run(panel, "torch", batch_regions=False)
    got, runner = mesh_run(panel, "torch", 4, batch_regions=True)
    _assert_same(jax_batched, got)
    _assert_same(serial, got)
    kb = runner.kmer_pipeline
    assert kb.mesh is not None and kb.mesh.devices.shape == (2, 2)
    assert kb.rpb == 32 and kb.dispatched > 0


def test_batched_runner_rounds_regions_a_batch_to_the_regions_axis(mesh_run):
    one, _ = mesh_run(1, "torch", 1, batch_regions=True, kmer_regions_per_batch=3)
    got, runner = mesh_run(1, "torch", 4, batch_regions=True, kmer_regions_per_batch=3)
    assert runner.kmer_pipeline.rpb == 2  # 2 * max(1, 3 // 2), as the JAX runner rounds
    assert runner.kmer_pipeline.dispatched > 1
    _assert_same(one, got)


@pytest.mark.parametrize("batch_regions", [False, True], ids=["serial", "batched"])
def test_sharded_genome_index_in_the_runner(batch_regions, mesh_run):
    serial, _ = mesh_run(7, "torch", batch_regions=False)
    got, runner = mesh_run(7, "torch", 4, batch_regions=batch_regions,
                           shard_genome_index=True)
    assert isinstance(runner.genome, ShardedGenomeIndex)
    assert runner.genome.mesh.devices.size == 4
    _assert_same(serial, got)
    one, runner = mesh_run(7, "torch", 1, batch_regions=False, shard_genome_index=True)
    assert not isinstance(runner.genome, ShardedGenomeIndex)  # 1 device: kept replicated
    _assert_same(serial, one)
