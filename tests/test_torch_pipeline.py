"""The whole serial slice: one planted-SV panel through breakmer_tpu and
through breakmer_tpu_torch on the CPU. svs.out, the VCF and each region's
ledger rows / VCF records must be byte-identical (tolerance 0). One case
hands the port the reference-data caches the JAX run wrote (region codes
.npy, genome seed index .npz): it must load them, rebuild nothing (the
.npz is converted once into the port's mapped index), and give the same
output."""

import argparse
import json

import pytest

from breakmer_tpu.config import Config as JaxConfig
from breakmer_tpu.runner import Runner as JaxRunner
from breakmer_tpu_torch.config import Config as TorchConfig
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
    config = JaxConfig if runner_cls is JaxRunner else TorchConfig
    cfg = config(**{**cfg_kwargs, "analysis_dir": str(out), "device": "cpu"})
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
    # the .npz is converted once into the port's mapped index beside it;
    # every artifact the JAX run wrote stays as it was
    after = {p.name: p.stat().st_mtime_ns for p in refdata.iterdir()}
    assert {n: after[n] for n in before} == before
    assert sorted(set(after) - set(before)) == ["genome_genome_index_v3_k11"]
    metrics = json.loads((tmp_path / "torch" / "metrics.json").read_text())
    assert metrics["index"]["source"] == "converted"


def _run_actions(parser):
    subs = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return sorted((a.dest, tuple(a.option_strings)) for a in subs.choices["run"]._actions)


def test_cli_run_flags_match_jax():
    from breakmer_tpu.cli import build_parser as jax_parser
    from breakmer_tpu_torch.cli import build_parser as torch_parser

    assert _run_actions(torch_parser()) == _run_actions(jax_parser())


def test_cli_run_profile_writes_trace_and_same_output(tmp_path):
    from breakmer_tpu_torch.cli import main

    cfg_kwargs, _ = _scenario(1, tmp_path)
    cfg_kwargs.pop("reference_data_dir")
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({**cfg_kwargs, "device": "cpu", "log_level": "WARNING"}))
    out = {}
    for name, extra in (("plain", []), ("profiled", ["--profile"])):
        adir = tmp_path / name
        assert main(["run", str(cfg_file), "--analysis-dir", str(adir), *extra]) == 0
        out[name] = (adir / "output" / "prop_svs.out").read_bytes()
    assert out["profiled"] == out["plain"]
    assert out["plain"].count(b"\n") > 1
    assert not (tmp_path / "plain" / "trace").exists()
    traces = list((tmp_path / "profiled" / "trace").iterdir())
    assert traces and all(p.stat().st_size > 0 for p in traces)


def test_panel_ab_runs_two_trees_in_turns_on_the_host(tmp_path):
    """tools/panel_ab.py, the A/B of two checkouts, on a 2-gene panel with
    one checkout on both sides: every run ends, alternates and writes the
    same svs.out."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "breakmer_tpu_torch" / "tools" / "panel_ab.py"),
         str(root), str(root), "--pairs", "2", "--genes", "2", "--paths", "serial",
         "--device", "cpu", "--work", str(tmp_path)],
        capture_output=True, text=True, timeout=300, check=True).stdout.splitlines()
    runs = [json.loads(line) for line in out[:-1]]
    assert [r["tree"] for r in runs] == ["A", "B", "B", "A"]
    summary = json.loads(out[-1])
    assert summary["svs_identical"] and summary["card"] is None
    assert {k: v["runs"] for k, v in summary["regions_per_s"].items()} == {
        "serial A": 2, "serial B": 2}
