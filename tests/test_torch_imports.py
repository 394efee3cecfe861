"""The port imports torch and never jax, nor any module of breakmer_tpu:
its leaf modules and its scenario generator are copies that differ from
their originals only in their imports. Its device selection raises
instead of falling back; its runner runs every knob of the JAX runner."""

import ast
import dataclasses
import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

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
    from breakmer_tpu_torch.config import Config

    files = {"t.bed": "chr1\t100\t200\tG\n", "g.fa": ">chr1\nACGT\n", "s.sam": ""}
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    return Config(targets_bed_file=str(tmp_path / "t.bed"),
                  reference_fasta=str(tmp_path / "g.fa"),
                  sample_bam_file=str(tmp_path / "s.sam"), analysis_dir=str(tmp_path / "a"),
                  device="cpu", **knobs)


@pytest.mark.parametrize("knob", ["shard_genome_index", "multihost"])
def test_runner_runs_multi_device_knobs(knob, tmp_path, monkeypatch):
    """Each knob's setup() and run() succeed on the tiny config (with four
    local CPU devices, so the seed table is sharded) and write the
    unsharded one-process run's bytes."""
    from breakmer_tpu_torch import device
    from breakmer_tpu_torch.parallel.index_shard import ShardedGenomeIndex
    from breakmer_tpu_torch.runner import Runner

    out = {}
    for label, knobs in (("plain", {}), ("knob", {knob: True})):
        cfg = dataclasses.replace(_tiny_config(tmp_path, **knobs),
                                  analysis_dir=str(tmp_path / label))
        runner = Runner(cfg)
        if label == "knob":
            monkeypatch.setattr(device, "local_devices", lambda d="auto": [torch.device("cpu")] * 4)
        runner.setup()
        assert runner.run() == []
        out[label] = [(tmp_path / label / "output" / name).read_bytes()
                      for name in ("breakmer_tpu_svs.out", "breakmer_tpu.vcf")]
    assert out["knob"] == out["plain"]
    assert isinstance(runner.genome, ShardedGenomeIndex) == (knob == "shard_genome_index")


def test_runner_runs_batch_regions(tmp_path):
    from breakmer_tpu_torch.runner import Runner

    runner = Runner(_tiny_config(tmp_path, batch_regions=True))
    runner.setup()
    assert runner.run() == []
    assert runner.kmer_pipeline is not None
    assert (tmp_path / "a" / "output").is_dir()


# -- no import of the JAX package, jax or the tests -------------------------

_FORBIDDEN = ("breakmer_tpu", "jax", "tests")


def _forbidden(name):
    return name is not None and any(name == f or name.startswith(f + ".")
                                    for f in _FORBIDDEN)


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            if node.module in _FORBIDDEN:  # "from breakmer_tpu import native"
                yield from (f"{node.module}.{a.name}" for a in node.names)


def test_no_module_imports_the_jax_package_jax_or_tests():
    files = sorted((REPO / "breakmer_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 50
    bad = {}
    for path in files:
        names = [n for n in _imported_names(ast.parse(path.read_text())) if _forbidden(n)]
        if names:
            bad[str(path.relative_to(REPO))] = names
    assert bad == {}
    # the scan sees lazy imports inside functions too
    lazy = "def f():\n    from breakmer_tpu.io import bam\n    import jax.numpy\n"
    assert sorted(filter(_forbidden, _imported_names(ast.parse(lazy)))) == [
        "breakmer_tpu.io", "jax.numpy"]


def test_cli_run_imports_no_module_of_the_jax_package(tmp_path):
    """``python -m breakmer_tpu_torch.cli run`` on a tiny CPU panel made by
    the port's own scenario copy; ``-X importtime`` lists every module
    the process imported."""
    from breakmer_tpu_torch.testing.scenarios import build_scenario

    cfg_kwargs, _ = build_scenario(1, tmp_path, n_genes=2, kinds=["ins", "del"])
    cfg_kwargs.update(device="cpu", batch_regions=False, log_level="WARNING",
                      analysis_dir=str(tmp_path / "a"))
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps(cfg_kwargs))
    proc = subprocess.run([sys.executable, "-X", "importtime", "-m", "breakmer_tpu_torch.cli",
                           "run", str(cfg_file)], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    imported = {line.rsplit("|", 1)[1].strip() for line in proc.stderr.splitlines()
                if line.startswith("import time:") and "|" in line}
    assert "breakmer_tpu_torch.runner" in imported and "torch" in imported
    assert sorted(n for n in imported if _forbidden(n)) == []
    assert (tmp_path / "a" / "output" / "prop_svs.out").read_bytes().count(b"\n") > 1


# -- the copies equal their originals up to their imports -------------------

_COPIES = ([(f"breakmer_tpu/{n}.py", f"breakmer_tpu_torch/{n}.py")
            for n in ("config", "encode", "native")]
           + [(f"breakmer_tpu/io/{n}.py", f"breakmer_tpu_torch/io/{n}.py")
              for n in ("__init__", "bed", "sam", "bam", "bai", "csi", "fasta", "fastq",
                        "twobit")]
           + [(f"breakmer_tpu/utils/{n}.py", f"breakmer_tpu_torch/utils/{n}.py")
              for n in ("__init__", "logging", "meter", "rmask", "complexity")]
           + [(f"tests/{n}.py", f"breakmer_tpu_torch/testing/{n}.py")
              for n in ("fixtures", "scenarios")])
_IMPORT_LINE = re.compile(r"^\s*(from|import)\s+(breakmer_tpu|tests)[.\s]")
_DEVICE_COMMENT = ("# auto | cpu | tpu (see breakmer_tpu.device)",
                   "# auto | cuda | cpu (see breakmer_tpu_torch.device)")


def _renamed(line):
    line = re.sub(r"\bbreakmer_tpu\b(?!_torch)", "breakmer_tpu_torch", line)
    return re.sub(r"\btests\.(fixtures|scenarios)\b", r"breakmer_tpu_torch.testing.\1", line)


@pytest.mark.parametrize("original,copy", _COPIES, ids=[c for _, c in _COPIES])
def test_copy_equals_its_original_up_to_imports(original, copy):
    a = (REPO / original).read_text().splitlines()
    b = (REPO / copy).read_text().splitlines()
    assert len(a) == len(b)
    changed = 0
    for n, (x, y) in enumerate(zip(a, b), 1):
        if x == y:
            continue
        changed += 1
        if _IMPORT_LINE.match(x):
            assert y == _renamed(x), f"{copy}:{n}"
        else:
            assert original.endswith("config.py") and x.replace(*_DEVICE_COMMENT) == y, \
                f"{copy}:{n}: {y!r}"
    wants_imports = any(_IMPORT_LINE.match(x) for x in a)
    assert (changed > 0) == (wants_imports or original.endswith("config.py"))


@pytest.mark.parametrize("seed", [1, 5, 7])
def test_scenario_copy_writes_the_same_files(seed, tmp_path):
    from breakmer_tpu_torch.testing.scenarios import build_scenario as port_build
    from tests.scenarios import build_scenario as test_build

    kw = dict(n_genes=4, with_normal_germline=True, multi_sv_gene=True)
    out = {}
    for name, build in (("tests", test_build), ("port", port_build)):
        work = tmp_path / name
        work.mkdir()
        cfg_kwargs, checks = build(seed, work, **kw)
        files = {p.relative_to(work).as_posix(): p.read_bytes()
                 for p in sorted(work.rglob("*")) if p.is_file()}
        cfg = {k: (str(Path(v).relative_to(work)) if isinstance(v, str) and v.startswith(str(work))
                   else v) for k, v in cfg_kwargs.items()}
        out[name] = (files, cfg, {g: k for g, (k, _) in checks.items()})
    assert {n.rsplit(".", 1)[-1] for n in out["port"][0]} >= {"fa", "sam", "bed"}
    assert out["port"] == out["tests"]


def test_both_configs_parse_a_file_alike(tmp_path):
    from breakmer_tpu.config import Config as JaxConfig
    from breakmer_tpu_torch.config import Config as TorchConfig

    path = tmp_path / "breakmer.cfg"
    path.write_text("# reference-style key=value\nkmer_size=17\nnprocs=3\n"
                    "batch_regions=true\nmin_contig_len=80\nanalysis_name=x\n"
                    "device=cpu\nunknown_key=1\n")
    ref, got = JaxConfig.from_file(path), TorchConfig.from_file(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.kmer_size == 17 and got.batch_regions is True
    path.write_text(json.dumps({"kmer_size": 21, "contig_pad_tiers": [64, 128]}))
    assert dataclasses.asdict(TorchConfig.from_file(path)) == dataclasses.asdict(
        JaxConfig.from_file(path))
