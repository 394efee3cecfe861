"""Multi-host runs of the port: breakmer_tpu_torch.parallel.multihost
against breakmer_tpu.parallel.multihost on the same inputs (partition,
ledger-shard merge, a one-process ``multihost=True`` run), then real
multi-process runs: N OS processes join a gloo rendezvous on 127.0.0.1
(``init_distributed``), each runs its round-robin partition on the CPU,
and process 0 merges the shard ledgers. The workers import the port
alone. Each merged svs.out is byte-identical to the port's and to
breakmer_tpu's single-process run of the same panel."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

import bench_panel as jax_bench_panel
from breakmer_tpu.config import Config as JaxConfig
from breakmer_tpu.parallel import multihost as jmh
from breakmer_tpu.runner import Runner as JaxRunner
from breakmer_tpu_torch import bench_panel
from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.parallel import multihost as tmh
from breakmer_tpu_torch.runner import Runner

REPO = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------- in-process

@pytest.mark.parametrize("n_names,count", [(10, 4), (6, 4), (3, 1), (7, 3), (2, 5)])
def test_partition_matches_jax(n_names, count):
    names = [f"G{i}" for i in range(n_names)]
    parts = [tmh.partition_targets(names, p, count) for p in range(count)]
    assert parts == [jmh.partition_targets(names, p, count) for p in range(count)]
    assert sorted(n for part in parts for n in part) == sorted(names)
    assert tmh.shard_ledger_path("a", 3) == jmh.shard_ledger_path("a", 3)


def _write_shards(root: Path, names, count, missing=(), torn=False):
    """Shard snapshots for even processes, JSONL append logs for odd ones
    (a torn tail line on each if ``torn``); ``missing`` processes write
    nothing."""
    for p in range(count):
        if p in missing:
            continue
        entries = {n: {"rows": [[n, "chr1:1", "10M"]], "error": None}
                   for n in tmh.partition_targets(names, p, count)}
        path = tmh.shard_ledger_path(root, p)
        if p % 2 == 0:
            path.write_text(json.dumps(entries))
        else:
            lines = [json.dumps({"name": n, "entry": e}) for n, e in entries.items()]
            if torn:
                lines.append('{"name": "G0", "entr')
            path.with_suffix(".jsonl").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("case", ["complete", "missing_shard", "torn_tail"])
def test_merge_ledger_shards_matches_jax(case, tmp_path):
    names = [f"G{i}" for i in range(7)]
    _write_shards(tmp_path, names, 3, missing=(2,) if case == "missing_shard" else (),
                  torn=case == "torn_tail")
    kw = dict(wait_timeout_s=0.3, poll_s=0.1)
    got = tmh.merge_ledger_shards(tmp_path, names, 3, **kw)
    assert got == jmh.merge_ledger_shards(tmp_path, names, 3, **kw)
    want = set(names) - ({"G2", "G5"} if case == "missing_shard" else set())
    assert set(got) == want and got["G4"]["rows"][0][0] == "G4"


def test_init_distributed_single_process_joins_nothing():
    import torch.distributed as dist

    assert tmh.init_distributed("127.0.0.1:1", 1, 0) == (0, 1)
    assert tmh.init_distributed() == (0, 1)
    assert not dist.is_initialized()
    tmh.shutdown_distributed()  # nothing to destroy


def test_one_process_multihost_run_matches_plain_and_jax(tmp_path):
    """The degenerate 1-process multihost run writes the plain run's
    output through its shard ledger, in both packages."""
    out = {}
    for package, (config, runner_cls, build) in {
        "jax": (JaxConfig, JaxRunner, lambda w: jax_bench_panel.build_panel(w, 3, 10)),
        "torch": (Config, Runner, lambda w: bench_panel.build_panel(w, 3, 10, device="cpu")),
    }.items():
        work = tmp_path / package
        work.mkdir()
        cfg = build(work)
        for label, knobs in (("plain", {}), ("mh", {"multihost": True})):
            runner = runner_cls(config(**{**cfg.__dict__, **knobs,
                                          "analysis_dir": str(work / label)}))
            runner.setup()
            assert (runner.process_index, runner.process_count) == (0, 1)
            runner.run()
            out[package, label] = (work / label / "output" / "panelbench_svs.out").read_bytes()
        assert jmh.shard_ledger_path(work / "mh", 0).exists()
        assert not (work / "mh" / "ledger.json").exists()
    assert len(set(out.values())) == 1 and out["torch", "mh"].count(b"\n") == 3


# --------------------------------------------------------- multi-process

# argv: work_dir process_id port num_processes die_after(-1=never) resume(0/1)
#       dying ("every" process, or "process0" alone)
WORKER = r"""
import json, os, sys
from pathlib import Path
from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.runner import Runner

work = Path(sys.argv[1]); pid = int(sys.argv[2]); port = sys.argv[3]
nprocs = int(sys.argv[4]); die_after = int(sys.argv[5])
resume = bool(int(sys.argv[6])); dying = sys.argv[7]
cfg = Config(**{**json.loads((work / "cfg.json").read_text()),
                "multihost": True, "num_processes": nprocs, "process_id": pid,
                "coordinator_address": f"127.0.0.1:{port}"})
r = Runner(cfg)
r.setup()
assert r.process_count == nprocs and r.process_index == pid
if die_after >= 0 and (dying == "every" or pid == 0):
    # abrupt death (no cleanup, no snapshot) after N region checkpoints:
    # the shard ledger JSONL is all the rerun gets to resume from
    orig = r._append_ledger
    state = {"n": 0}
    def append_then_die(name, entry):
        orig(name, entry)
        state["n"] += 1
        if state["n"] > die_after:
            os._exit(17)
    r._append_ledger = append_then_die
pre = len(r._load_ledger()) if resume else 0
r.run(resume=resume)
import torch.distributed as dist
assert not dist.is_initialized()
print(f"WORKER_OK {pid} {len(r.targets)} resumed={pre}")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(work: Path, nprocs: int, die_after: int = -1, resume: bool = False,
           timeout: int = 240, ok_codes=(0,), dying: str = "every"):
    """Run the worker as nprocs OS processes; (procs, outs). Retries once
    on a fresh port (another process can take the probed port before
    process 0 binds it); a return code outside ``ok_codes`` triggers the
    retry. A hung worker is killed by its PID."""
    worker_py = work / "worker.py"
    worker_py.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for attempt in (0, 1):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, str(worker_py), str(work), str(p), str(port), str(nprocs),
             str(die_after), str(int(resume)), dying],
            cwd=str(work), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for p in range(nprocs)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            outs = []
            for p in procs:
                if p.poll() is None:
                    p.kill()
                outs.append((p.communicate(timeout=10)[0] or "") + "\n[TIMEOUT: killed]")
            if attempt == 1:
                pytest.fail("multihost workers hung twice: " + outs[0][-2000:])
            continue
        if all(p.returncode in ok_codes for p in procs) or attempt == 1:
            break
    return procs, outs


def _panel(work: Path, n_genes: int):
    """The bench panel of ``n_genes`` under ``work`` (the port's ``build_panel``;
    the workers read cfg.json) and the JAX package's copy of it under
    ``work/jax``."""
    work.mkdir(parents=True, exist_ok=True)
    cfg = bench_panel.build_panel(work, n_genes, 10, device="cpu")
    (work / "cfg.json").write_text(json.dumps(cfg.__dict__))
    (work / "jax").mkdir()
    return cfg, jax_bench_panel.build_panel(work / "jax", n_genes, 10)


def _single_process_outputs(cfg, jax_cfg):
    """svs.out of the port's and of breakmer_tpu's one-process runs, and
    the port's VCF (same reference file as the workers')."""
    port = Runner(Config(**{**cfg.__dict__, "analysis_dir": cfg.analysis_dir + "_solo"}))
    port.setup()
    port.run()
    jax = JaxRunner(jax_cfg)
    jax.setup()
    jax.run()
    solo = Path(cfg.analysis_dir + "_solo") / "output"
    return ((solo / "panelbench_svs.out").read_bytes(),
            (Path(jax_cfg.analysis_dir) / "output" / "panelbench_svs.out").read_bytes(),
            (solo / "panelbench.vcf").read_bytes())


def _assert_merged_equals_single(cfg, jax_cfg, genes):
    out = Path(cfg.analysis_dir) / "output"
    merged = (out / "panelbench_svs.out").read_bytes()
    port_solo, jax_solo, port_vcf = _single_process_outputs(cfg, jax_cfg)
    assert merged == port_solo == jax_solo
    assert (out / "panelbench.vcf").read_bytes() == port_vcf
    rows = [line.split("\t")[0] for line in merged.decode().splitlines()[1:] if line.strip()]
    assert rows == genes  # a planted insertion in every even gene, in panel order


@pytest.mark.timeout(280)
def test_two_process_multihost_run(tmp_path):
    cfg, jax_cfg = _panel(tmp_path / "mh", 6)
    procs, outs = _spawn(tmp_path / "mh", nprocs=2)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    assert "WORKER_OK 0 3" in outs[0] and "WORKER_OK 1 3" in outs[1]
    _assert_merged_equals_single(cfg, jax_cfg, ["GENE0", "GENE2", "GENE4"])


@pytest.mark.timeout(280)
def test_four_process_uneven_split(tmp_path):
    """6 regions over 4 processes: round-robin partitions 2/2/1/1."""
    cfg, jax_cfg = _panel(tmp_path / "mh", 6)
    procs, outs = _spawn(tmp_path / "mh", nprocs=4)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    for pid, want in ((0, 2), (1, 2), (2, 1), (3, 1)):
        assert f"WORKER_OK {pid} {want}" in outs[pid], outs[pid][-800:]
    _assert_merged_equals_single(cfg, jax_cfg, ["GENE0", "GENE2", "GENE4"])


@pytest.mark.timeout(280)
@pytest.mark.parametrize("dying", ["every", "process0"])
def test_worker_death_then_ledger_resume(dying, tmp_path):
    """Every worker (or process 0 alone, which holds gloo's store) dies
    abruptly (os._exit, no snapshot) after checkpointing ONE region; no
    peer hangs on the dead rendezvous: a survivor finishes its partition
    and exits cleanly. The rerun with resume=True picks the finished
    regions up from the shard JSONL logs, and the merged output is the
    single-process run's."""
    cfg, jax_cfg = _panel(tmp_path / "mh", 4)
    codes = (17,) if dying == "every" else (0, 17)
    procs, outs = _spawn(tmp_path / "mh", nprocs=2, die_after=0, ok_codes=codes, dying=dying)
    want = [17, 17] if dying == "every" else [17, 0]
    assert [p.returncode for p in procs] == want, [o[-400:] for o in outs]
    for pid, n in ((0, 1), (1, 1 if dying == "every" else 2)):
        ap = Path(cfg.analysis_dir) / f"ledger_p{pid}.jsonl"
        assert len([line for line in ap.read_text().splitlines() if line.strip()]) == n
    assert not (Path(cfg.analysis_dir) / "output" / "panelbench_svs.out").exists()

    procs, outs = _spawn(tmp_path / "mh", nprocs=2, resume=True)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    assert "WORKER_OK 0 2 resumed=1" in outs[0], outs[0][-800:]
    resumed = 1 if dying == "every" else 2
    assert f"WORKER_OK 1 2 resumed={resumed}" in outs[1], outs[1][-800:]
    _assert_merged_equals_single(cfg, jax_cfg, ["GENE0", "GENE2"])
