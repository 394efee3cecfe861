"""Region fault isolation on the CPU, the port against breakmer_tpu: an
ordinary exception in a region is recorded as that region's ``error``,
byte for byte as the JAX package records it, and the run goes on; a
kernel launch error or a fault of the card (``_build.DEVICE_FAULTS``)
ends the run instead, through each of the three isolation sites
(``TargetPipeline.run``, the batched runner's assembly and its
classification), and ``cli run`` exits nonzero."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import breakmer_tpu.pipeline as jax_pipeline
import breakmer_tpu_torch.align.realign as torch_realign
import breakmer_tpu_torch.pipeline as torch_pipeline
from breakmer_tpu.config import Config as JaxConfig
from breakmer_tpu.runner import Runner as JaxRunner
from breakmer_tpu_torch._build import DEVICE_FAULTS, KernelLaunchError
from breakmer_tpu_torch.config import Config as TorchConfig
from breakmer_tpu_torch.runner import Runner as TorchRunner
from tests.scenarios import build_scenario
from tests.test_property_e2e import _CI_KINDS

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    work = tmp_path_factory.mktemp("faults")
    cfg_kwargs, _ = build_scenario(1, work, n_genes=4, kinds=_CI_KINDS[1],
                                   with_normal_germline=True, multi_sv_gene=True)
    cfg_kwargs.pop("reference_data_dir")
    return cfg_kwargs, work


def _runner(runner_cls, cfg_kwargs, out, **over):
    config = JaxConfig if runner_cls is JaxRunner else TorchConfig
    runner = runner_cls(config(**{**cfg_kwargs, "analysis_dir": str(out), "device": "cpu",
                                  "log_level": "CRITICAL", **over}))
    runner.setup()
    return runner


def _raising(original, victim, exc):
    """``original`` as a method that raises ``exc`` for the target named
    ``victim`` (every target where victim is None)."""
    def method(self, *a, **kw):
        if victim is None or self.target.name == victim:
            raise exc
        return original(self, *a, **kw)
    return method


def test_device_faults_are_the_launch_error_and_torchs_card_error():
    assert issubclass(KernelLaunchError, RuntimeError)
    assert DEVICE_FAULTS == (KernelLaunchError, torch.AcceleratorError)


_FAULTS = {"launch": KernelLaunchError("region_kmers (R=200) launch failed: invalid argument"),
           "card": torch.AcceleratorError("CUDA error: an illegal memory access was encountered")}


@pytest.mark.parametrize("wrapper", ["kmer", "sw"])
@pytest.mark.parametrize("fault", list(_FAULTS))
def test_a_device_fault_in_a_region_ends_the_serial_run(scenario, tmp_path, monkeypatch,
                                                        wrapper, fault):
    """The k-mer call or the SW launch of the serial path raising a device
    fault: ``Runner.run()`` raises it, and no region records it."""
    cfg_kwargs, _ = scenario
    exc = _FAULTS[fault]

    def raises(*a, **kw):
        raise exc

    if wrapper == "kmer":
        monkeypatch.setattr(torch_pipeline, "sample_only_kmers", raises)
    else:
        monkeypatch.setattr(torch_realign, "sw_score_batch", raises)
    runner = _runner(TorchRunner, cfg_kwargs, tmp_path, batch_regions=False)
    with pytest.raises(type(exc)) as raised:
        runner.run()
    assert raised.value is exc
    assert not any(r.error for r in runner.results)


@pytest.mark.parametrize("site", ["assemble_contigs", "classify_contigs"])
@pytest.mark.parametrize("nprocs", [1, 2])
def test_a_device_fault_ends_the_batched_run(scenario, tmp_path, monkeypatch, site, nprocs):
    """The batched runner's two isolation sites (assembly, classification),
    in the main thread and in its pool: a launch error raised there ends
    the run."""
    cfg_kwargs, _ = scenario
    exc = _FAULTS["launch"]
    monkeypatch.setattr(torch_pipeline.TargetPipeline, site,
                        _raising(getattr(torch_pipeline.TargetPipeline, site), None, exc))
    runner = _runner(TorchRunner, cfg_kwargs, tmp_path, batch_regions=True, nprocs=nprocs)
    with pytest.raises(KernelLaunchError) as raised:
        runner.run()
    assert raised.value is exc


def test_cli_run_exits_nonzero_on_a_launch_error(scenario, tmp_path):
    """``python -m breakmer_tpu_torch.cli run`` with the k-mer call raising
    a launch error: a nonzero exit and the error on stderr, no svs.out."""
    cfg_kwargs, _ = scenario
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**cfg_kwargs, "analysis_dir": str(tmp_path / "run"),
                               "device": "cpu", "log_level": "WARNING",
                               "batch_regions": False}))
    code = ("import sys\n"
            "import breakmer_tpu_torch.pipeline as p\n"
            "from breakmer_tpu_torch._build import KernelLaunchError\n"
            "def fail(*a, **k):\n"
            "    raise KernelLaunchError('region_kmers launch failed: invalid argument')\n"
            "p.sample_only_kmers = fail\n"
            "from breakmer_tpu_torch.cli import main\n"
            f"sys.exit(main(['run', {str(cfg)!r}]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "KernelLaunchError: region_kmers launch failed" in proc.stderr
    assert not (tmp_path / "run" / "output" / "prop_svs.out").exists()


def _outputs(out: Path) -> dict:
    ledger = json.loads((out / "ledger.json").read_text())
    return {"svs": (out / "output" / "prop_svs.out").read_bytes(),
            "vcf": (out / "output" / "prop.vcf").read_bytes(),
            "ledger": {n: (e["rows"], e["vcf"], e["error"]) for n, e in ledger.items()}}


@pytest.mark.parametrize("batch", [False, True], ids=["serial", "batched"])
def test_an_ordinary_region_error_is_isolated_as_in_jax(scenario, tmp_path, monkeypatch, batch):
    """A ValueError in one region (its k-mer stage on the serial path, its
    assembly on the batched one) is that region's error, and the other
    regions' calls stand: svs.out, the VCF and every ledger entry
    (rows, VCF records, error) byte-identical to breakmer_tpu's."""
    cfg_kwargs, _ = scenario
    site = "assemble_contigs" if batch else "find_sv_reads"
    got = {}
    for name, module, runner_cls in (("jax", jax_pipeline, JaxRunner),
                                     ("torch", torch_pipeline, TorchRunner)):
        runner = _runner(runner_cls, cfg_kwargs, tmp_path / name, batch_regions=batch)
        victim = list(runner.targets)[1]
        original = getattr(module.TargetPipeline, site)
        monkeypatch.setattr(module.TargetPipeline, site,
                            _raising(original, victim, ValueError("planted region fault")))
        runner.run()
        monkeypatch.setattr(module.TargetPipeline, site, original)
        got[name] = _outputs(tmp_path / name)
    assert got["torch"] == got["jax"]
    errors = [err for _, _, err in got["torch"]["ledger"].values() if err]
    assert errors and all("planted region fault" in err for err in errors)
    assert got["torch"]["svs"].count(b"\n") > 1  # the other regions' calls
