"""The whole serial slice: one planted-SV panel through breakmer_tpu and
through breakmer_tpu_torch on the CPU. svs.out, the VCF and each region's
ledger rows / VCF records must be byte-identical (tolerance 0). One case
hands the port the reference-data caches the JAX run wrote (region codes
.npy, genome seed index .npz): it must load them, rebuild nothing, and
give the same output."""

import json

import pytest

from breakmer_tpu.config import Config
from breakmer_tpu.runner import Runner as JaxRunner
from breakmer_tpu_torch.runner import Runner as TorchRunner
from tests.scenarios import build_scenario
from tests.test_property_e2e import _CI_KINDS


def _scenario(seed, tmp_path):
    cfg_kwargs, checks = build_scenario(
        seed, tmp_path, n_genes=4, kinds=_CI_KINDS[seed],
        with_normal_germline=True, multi_sv_gene=True,
    )
    cfg_kwargs["batch_regions"] = False  # the serial path, both packages
    return cfg_kwargs, checks


def _run(runner_cls, cfg_kwargs, out, prepare=None):
    cfg = Config(**{**cfg_kwargs, "analysis_dir": str(out), "device": "cpu"})
    runner = runner_cls(cfg)
    runner.setup()
    if prepare is not None:
        prepare(runner)
    events = runner.run()
    ledger = json.loads((out / "ledger.json").read_text())
    return events, {
        "svs": (out / "output" / "prop_svs.out").read_bytes(),
        "vcf": (out / "output" / "prop.vcf").read_bytes(),
        "ledger": {n: (e["rows"], e["vcf"], e["error"]) for n, e in ledger.items()},
    }


def _assert_identical(ref, got):
    assert got["svs"] == ref["svs"]
    assert got["vcf"] == ref["vcf"]
    assert got["ledger"] == ref["ledger"]
    assert all(err is None for _, _, err in got["ledger"].values())


@pytest.mark.parametrize("seed", [1, 7])
def test_port_matches_jax_serial(seed, tmp_path):
    cfg_kwargs, checks = _scenario(seed, tmp_path)
    cfg_kwargs.pop("reference_data_dir")  # each run builds its own index
    _, ref = _run(JaxRunner, cfg_kwargs, tmp_path / "jax")
    events, got = _run(TorchRunner, cfg_kwargs, tmp_path / "torch")
    _assert_identical(ref, got)
    assert got["svs"].count(b"\n") > 1  # calls were made
    for gene, (kind, check) in checks.items():
        evs = [e for e in events if e.genes.split(",")[0] == gene]
        assert not check(evs), f"seed {seed} {gene} ({kind})"


def test_port_reuses_jax_reference_caches(tmp_path, monkeypatch):
    cfg_kwargs, _ = _scenario(1, tmp_path)
    _, ref = _run(JaxRunner, cfg_kwargs, tmp_path / "jax")
    refdata = tmp_path / "refdata"
    before = {p.name: p.stat().st_mtime_ns for p in refdata.iterdir()}
    assert any(n.endswith(".npz") for n in before)
    assert any(n.endswith("_codes.npy") for n in before)

    import breakmer_tpu_torch.runner as trunner

    def no_build(*a, **kw):
        raise AssertionError("the port rebuilt a cached reference artifact")

    class NoBuildIndex(trunner.GenomeIndex):
        __init__ = no_build

    def prepare(runner):
        runner.fasta.fetch_codes = no_build  # region codes must come from .npy

    monkeypatch.setattr(trunner, "GenomeIndex", NoBuildIndex)
    _, got = _run(TorchRunner, cfg_kwargs, tmp_path / "torch", prepare=prepare)
    _assert_identical(ref, got)
    assert {p.name: p.stat().st_mtime_ns for p in refdata.iterdir()} == before
