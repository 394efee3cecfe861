"""The port imports torch and never jax; its device selection raises
instead of falling back; its runner refuses the knobs it has not ported
and runs the ones it has."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import breakmer_tpu_torch

REPO = Path(__file__).resolve().parent.parent


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(breakmer_tpu_torch.__path__,
                                              "breakmer_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "breakmer_tpu_torch.ops.sw_cuda" in mods and len(mods) >= 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_cli_version():
    proc = subprocess.run([sys.executable, "-m", "breakmer_tpu_torch.cli", "version"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == breakmer_tpu_torch.__version__


def test_device_resolution_has_no_fallback(monkeypatch):
    import torch

    from breakmer_tpu_torch.device import resolve

    assert resolve("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("auto", "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device=cpu"):
            resolve(name)
    with pytest.raises(ValueError):
        resolve("tpu")


def _tiny_config(tmp_path, **knobs):
    from breakmer_tpu.config import Config

    files = {"t.bed": "chr1\t100\t200\tG\n", "g.fa": ">chr1\nACGT\n", "s.sam": ""}
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    return Config(targets_bed_file=str(tmp_path / "t.bed"),
                  reference_fasta=str(tmp_path / "g.fa"),
                  sample_bam_file=str(tmp_path / "s.sam"), analysis_dir=str(tmp_path / "a"),
                  device="cpu", **knobs)


@pytest.mark.parametrize("knob", ["shard_genome_index", "multihost"])
def test_runner_refuses_unported_knobs(knob, tmp_path):
    from breakmer_tpu_torch.runner import Runner

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Runner(_tiny_config(tmp_path, **{knob: True})).setup()


def test_runner_runs_batch_regions(tmp_path):
    from breakmer_tpu_torch.runner import Runner

    runner = Runner(_tiny_config(tmp_path, batch_regions=True))
    runner.setup()
    assert runner.run() == []
    assert runner.kmer_pipeline is not None
    assert (tmp_path / "a" / "output").is_dir()
