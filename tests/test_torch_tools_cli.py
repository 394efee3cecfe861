"""What every tool of the port shares, on the CPU: each takes ``--device``
and refuses to run without a card unless given ``cpu``; no default output
path names a file the repository holds. And ``chip_smoke.py`` finds the
port from the working directory, wherever the script lies, and fails in a
directory that holds nothing else of the repository."""

import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
# each tool ported from tools/ this round, with the arguments its main needs
TOOLS = {
    "gpu_agreement": [], "sweep_accuracy": [], "sweep_envelope": [], "sweep_fp": [],
    "tandem_floor": [], "sweep_envelope_vaf": [], "triage_scenario": ["1"],
    "bench_panel_scaling": [], "bench_genome_index": [], "bench_index_gate": [],
    "bench_genome_e2e": [], "probe_fetch": [], "bench_bounded_ingest": [],
}


def _tool(name):
    return importlib.import_module(f"breakmer_tpu_torch.tools.{name}")


def test_every_jax_tool_has_a_port():
    ported_earlier = {"sw_ceiling_probe", "probe_swar_i16", "probe_swar_i16b",
                      "probe_mosaic_cummax"}
    renamed = {"tpu_agreement": "gpu_agreement", "probe_relay_fetch": "probe_fetch"}
    jax_tools = {p.stem for p in (REPO / "tools").glob("*.py")}
    assert {renamed.get(n, n) for n in jax_tools - ported_earlier} == set(TOOLS)
    for name in TOOLS:
        assert (REPO / "breakmer_tpu_torch" / "tools" / f"{name}.py").is_file()


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_refuses_to_run_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        _tool(name).main(TOOLS[name])


def _tracked_files():
    out = subprocess.run(["git", "ls-files"], cwd=REPO, capture_output=True, text=True)
    if out.returncode != 0:  # a checkout without git: every file is the repo's
        return {p.relative_to(REPO).as_posix() for p in REPO.rglob("*") if p.is_file()}
    return set(out.stdout.split())


@pytest.mark.parametrize("name,flags", [
    ("sweep_accuracy", []), ("sweep_accuracy", ["--genome", "repeats"]),
    ("sweep_accuracy", ["--extremes"]), ("sweep_accuracy", ["--polymorphism"]),
    ("sweep_accuracy", ["--q-end", "20"]), ("sweep_envelope", []),
    ("sweep_envelope", ["--profile", "tuned"]), ("sweep_envelope", ["--sub-rates", "0.02"]),
    ("sweep_fp", []), ("tandem_floor", []), ("sweep_envelope_vaf", []),
])
def test_default_out_names_no_file_of_the_repo(name, flags):
    out = Path(_tool(name).parse_args(flags).out)
    assert out.parent == REPO / "build" / "tools"
    assert out.relative_to(REPO).as_posix() not in _tracked_files()


def _load_copy(tmp_path, cwd):
    """Load a copy of chip_smoke.py from ``tmp_path`` in a subprocess
    whose working directory is ``cwd``, as ``run_name="not_main"``."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    code = ("import runpy, sys\n"
            f"g = runpy.run_path({str(tmp_path / 'chip_smoke.py')!r}, run_name='not_main')\n"
            "print(g['ROOT'])\n"
            "print(g['breakmer_tpu_torch'].__file__)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_copy_outside_the_repo_finds_the_port(tmp_path):
    proc = _load_copy(tmp_path, REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    root, pkg = proc.stdout.split()
    assert Path(root) == REPO
    assert Path(pkg) == REPO / "breakmer_tpu_torch" / "__init__.py"


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script exits non-zero and prints no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
