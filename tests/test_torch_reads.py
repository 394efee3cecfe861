"""Every source of a sample's reads (``breakmer_tpu_torch/reads.py``) gives
the JAX package's run from the same source: the native columns of a
preloaded BAM, its records parsed once (no native library), its index a
region (``preload_max_mb`` under the file's size) and a parse of the file
a region (``preload_alignments`` off, no index), each on the serial path
and on the batched path with one and four host threads. svs.out, the VCF
and the ledger (rows, VCF records, errors and stats) are byte-identical to
``breakmer_tpu.runner.Runner``'s on the same config. ``depth_at`` and
``discordant_pairs()`` answer as the JAX runner's at every breakpoint the
run called, and a region whose reads fail is that region's error on the
serial path, as in the JAX package."""

import contextlib
import json
from unittest import mock

import pytest

import breakmer_tpu.native as jax_native
import breakmer_tpu.pipeline as jax_pipeline
import breakmer_tpu_torch.reads as torch_reads
from breakmer_tpu.config import Config as JaxConfig
from breakmer_tpu.runner import Runner as JaxRunner
from breakmer_tpu_torch import native
from breakmer_tpu_torch.config import Config as TorchConfig
from breakmer_tpu_torch.io import bam_ingest
from breakmer_tpu_torch.io.bam import write_bam
from breakmer_tpu_torch.io.sam import parse_sam_line
from breakmer_tpu_torch.runner import Runner as TorchRunner
from breakmer_tpu_torch.testing.scenarios import build_scenario

SOURCES = ["columns", "records", "indexed", "parse"]
# the class that serves each source (``NativeReads`` resolves to the first)
SERVED_BY = {"columns": torch_reads.ColumnReads, "records": torch_reads.PreloadedReads,
             "indexed": torch_reads.IndexedReads, "parse": torch_reads.ParsedReads}
# two regions a k-mer batch: three packed launches over the five regions,
# each dispatched while later regions still extract
PATHS = {"serial": dict(batch_regions=False),
         "batched1": dict(batch_regions=True, nprocs=1, kmer_regions_per_batch=2),
         "batched4": dict(batch_regions=True, nprocs=4, kmer_regions_per_batch=2)}
PACKAGES = {"jax": (JaxConfig, JaxRunner), "torch": (TorchConfig, TorchRunner)}


def _sorted_sample(cfg_kwargs, work):
    """The scenario's sample as coordinate-sorted SAM text and as a BAM of
    the same records in the same order, with its .bai."""
    lines = open(cfg_kwargs["sample_bam_file"]).read().splitlines()
    header = [x for x in lines if x.startswith("@SQ")]
    refs = [(f.split("SN:")[1].split("\t")[0], int(f.split("LN:")[1])) for f in header]
    order = {c: i for i, (c, _) in enumerate(refs)}
    body = [x for x in lines if x and not x.startswith("@")]
    recs = [parse_sam_line(x) for x in body]
    keyed = sorted(range(len(recs)), key=lambda i: (order.get(recs[i].rname, len(refs)), recs[i].pos))
    sam = work / "sample_sorted.sam"
    sam.write_text("\n".join(header + [body[i] for i in keyed]) + "\n")
    bam = work / "sample.bam"
    write_bam(bam, refs, [recs[i] for i in keyed], index="bai")
    return sam, bam


def _source_config(scenario, source: str) -> dict:
    """The config keys that pick ``source`` (``records`` also needs the
    native library away: ``_no_native``)."""
    _, _, sam, bam = scenario
    if source == "parse":
        return dict(sample_bam_file=str(sam), preload_alignments=False)
    if source == "indexed":
        return dict(sample_bam_file=str(bam), preload_max_mb=bam.stat().st_size / 2**21)
    return dict(sample_bam_file=str(bam))


def _no_native(source: str):
    """Both packages without their native library (the port also without
    its BAM ingest), for the records source."""
    if source != "records":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    for module in (native, jax_native, bam_ingest):
        stack.enter_context(mock.patch.object(module, "available", lambda: False))
    return stack


def _outputs(out):
    ledger = json.loads((out / "ledger.json").read_text())
    return {"svs": (out / "output" / "prop_svs.out").read_bytes(),
            "vcf": (out / "output" / "prop.vcf").read_bytes(),
            "ledger": {n: (e["rows"], e["vcf"], e["error"], e["stats"])
                       for n, e in ledger.items()}}


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    work = tmp_path_factory.mktemp("reads")
    cfg_kwargs, _ = build_scenario(7, work, n_genes=4, kinds=["inv", "trl", None, None],
                                   with_normal_germline=True, multi_sv_gene=True)
    cfg_kwargs.pop("reference_data_dir")  # each run builds its own
    return (work, cfg_kwargs) + _sorted_sample(cfg_kwargs, work)


def _runner(scenario, package, source, path, out):
    _, cfg_kwargs, _, _ = scenario
    config, runner_cls = PACKAGES[package]
    cfg = config(**{**cfg_kwargs, **_source_config(scenario, source), **PATHS[path],
                    "analysis_dir": str(out), "device": "cpu", "log_level": "WARNING"})
    with _no_native(source):
        runner = runner_cls(cfg)
        runner.setup()
    return runner


@pytest.fixture(scope="module")
def source_run(scenario):
    """source_run(package, source, path) -> (outputs, runner) of one run,
    once a module."""
    work = scenario[0]
    done = {}

    def run(package, source, path):
        if (package, source, path) not in done:
            out = work / f"{package}_{source}_{path}"
            runner = _runner(scenario, package, source, path, out)
            with _no_native(source):
                runner.run()
            done[package, source, path] = (_outputs(out), runner)
        return done[package, source, path]

    return run


def _served_by(runner):
    reads = runner.reads
    return type(reads.resolved if isinstance(reads, torch_reads.NativeReads) else reads)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("source", SOURCES)
def test_every_source_gives_the_jax_run(source_run, source, path):
    got, runner = source_run("torch", source, path)
    assert _served_by(runner) is SERVED_BY[source]
    if source == "columns":  # the BAM's fixed-width ingest, its rows gathered a region
        assert isinstance(runner.reads.resolved.fields, bam_ingest.BamFields)
    want, _ = source_run("jax", source, path)
    assert got["svs"] == want["svs"]
    assert got["vcf"] == want["vcf"]
    assert got["ledger"] == want["ledger"]
    assert got["svs"].count(b"\n") > 1 and not any(e[2] for e in got["ledger"].values())
    if source != "parse":  # the parse source counts no depth off the region
        assert got == source_run("torch", "columns", path)[0]


@pytest.mark.parametrize("source", SOURCES)
def test_depth_and_discordant_pairs_answer_as_jax(source_run, source):
    _, columns = source_run("torch", "columns", "serial")
    points = sorted({(chrom, pos + d) for result in columns.results for ev in result.all_events
                     for chrom, pos, _ in ev.breakpoints for d in (-1, 0, 1)})
    assert {chrom for chrom, _ in points} == {"chr1", "chr2"}  # a translocation's partner too
    _, port = source_run("torch", source, "serial")
    _, jax = source_run("jax", source, "serial")
    with _no_native(source):
        depths = [port.reads.depth_at(c, p) for c, p in points]
        assert depths == [jax._global_coverage_at(c, p) for c, p in points]
        pairs = port.reads.discordant_pairs().pairs
        assert pairs == jax._global_disc_pairs().pairs
    assert any(mate == "chr2" for _, _, mate, _ in pairs)
    served = {chrom for (chrom, _), depth in zip(points, depths) if depth}
    assert served == (set() if source == "parse" else {"chr1", "chr2"})


@pytest.mark.parametrize("source", SOURCES[1:])
def test_a_region_whose_reads_fail_is_its_error_as_in_jax(scenario, tmp_path, source):
    """A ValueError while a record source's region is extracted, on the
    serial path, is that region's error and the run goes on: svs.out, the
    VCF and every ledger entry as the JAX package records them."""
    got = {}
    for package, module in (("jax", jax_pipeline), ("torch", torch_reads)):
        runner = _runner(scenario, package, source, "serial", tmp_path / package)
        victim = list(runner.targets.values())[1].span(runner.cfg.region_buffer)
        original = module.extract_sv_reads

        def extract(records, region, cfg):
            if tuple(region) == tuple(victim):
                raise ValueError("planted read fault")
            return original(records, region, cfg)

        with _no_native(source), mock.patch.object(module, "extract_sv_reads", extract):
            runner.run()
        got[package] = _outputs(tmp_path / package)
    assert got["torch"] == got["jax"]
    errors = [err for _, _, err, _ in got["torch"]["ledger"].values() if err]
    assert len(errors) == 1 and "planted read fault" in errors[0]
    assert got["torch"]["svs"].count(b"\n") > 1  # the other regions' calls
