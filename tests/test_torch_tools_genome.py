"""The genome-scale benches of the port (breakmer_tpu_torch.tools.
bench_genome_index, bench_index_gate, bench_genome_e2e) on the CPU
against the JAX tools of tools/, loaded by path: the index bench at 0.3 Mbp,
the gate's build at 0.3 Mbp (TOTAL_BP and the baseline's path set in both
modules; the gate's missing-baseline exit on the port alone) and the end-to-end check at its 85 Mbp floor give JSON equal
apart from wall times, rates and RSS, and the end-to-end check's artifact size, which is the port's mapped directory."""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path
from unittest import mock

import breakmer_tpu.align.index as jax_index
from breakmer_tpu_torch.tools import bench_genome_e2e, bench_genome_index, bench_index_gate

REPO = Path(__file__).resolve().parent.parent


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def last_json(fn) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def without(rec, keys):
    return {k: v for k, v in rec.items() if k not in keys}


def test_index_bench_equals_the_jax_tool():
    jax_tool = load_jax_tool("bench_genome_index")
    with mock.patch.object(sys, "argv", ["bench_genome_index.py", "3e5"]):
        want = last_json(jax_tool.main)
    got = last_json(lambda: bench_genome_index.main(["3e5", "--device", "cpu"]))
    times = {"build_s", "save_s", "load_s", "queries_per_s", "fetch_2kb_us"}
    assert without(got, times) == without(want, times)
    assert set(got) == set(want) and got["n_seeds"] > 100_000 and got["query_recall"] == 1.0


def test_index_gate_equals_the_jax_tool(tmp_path):
    """--update, then the gate: the same lines apart from build times."""
    jax_tool = load_jax_tool("bench_index_gate")

    def jax_main(*args):
        with mock.patch.object(sys, "argv", ["bench_index_gate.py", *args]):
            return jax_tool.main()

    out = {}
    for side, mod, run in (("jax", jax_tool, jax_main),
                           ("port", bench_index_gate,
                            lambda *a: bench_index_gate.main([*a, "--device", "cpu"]))):
        with mock.patch.object(mod, "TOTAL_BP", 300_000), \
                mock.patch.object(mod, "BASELINE", tmp_path / f"{side}_baseline.json"):
            lines = []
            for args in (["--update", "--runs", "1"], ["--runs", "1"]):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = run(*args)
                lines.append((rc, json.loads(buf.getvalue().strip().splitlines()[-1])))
            out[side] = lines
    build = {"build_s", "build_s_all", "mbp_per_s"}
    for (_, got), (_, want) in zip(out["port"], out["jax"]):
        assert set(got) == set(want)
        assert without(got["index_gate"], build) == without(want["index_gate"], build)
    # --update: 0; the gate: 0 or 1 by the build's time against the baseline
    assert out["port"][0][0] == out["jax"][0][0] == 0
    assert out["port"][1][0] == (0 if out["port"][1][1]["ok"] else 1)


def test_index_gate_without_its_baseline_exits_2(tmp_path, monkeypatch):
    """The port's gate reads only its own baseline, and exits 2 without it
    (the build is stubbed: this is the gate's logic alone)."""
    assert bench_index_gate.BASELINE == REPO / "breakmer_tpu_torch" / "bench_index_cpu_baseline.json"
    monkeypatch.setattr(bench_index_gate, "BASELINE", tmp_path / "missing.json")
    monkeypatch.setattr(bench_index_gate, "one_build", lambda: 1.0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench_index_gate.main(["--device", "cpu"]) == 2
    line = json.loads(buf.getvalue())
    assert line["ok"] is False and "missing" in line["error"]
    assert line["index_gate"]["build_s_all"] == [1.0, 1.0, 1.0]


def test_genome_e2e_at_the_floor_equals_the_jax_tool():
    """The JAX tool wraps GenomeIndex.save/load when it is imported; the
    originals are put back afterwards."""
    save, load = jax_index.GenomeIndex.save, jax_index.GenomeIndex.load
    try:
        jax_tool = load_jax_tool("bench_genome_e2e")
        with mock.patch.object(sys, "argv", ["bench_genome_e2e.py", "85e6"]):
            want = last_json(jax_tool.main)
    finally:
        jax_index.GenomeIndex.save, jax_index.GenomeIndex.load = save, load
    got = last_json(lambda: bench_genome_e2e.main(["85e6", "--device", "cpu"]))
    assert set(got) == set(want)
    kept = {"metric", "total_bp", "calls", "ins_called", "del_called", "trl_called",
            "warm_equals_cold", "index_resident_mb"}
    assert {k: got[k] for k in kept} == {k: want[k] for k in kept}
    # the port's artifact is a directory of mapped arrays with the same
    # contents, but its dense bucket table is the offsets as queries use
    # them (int64, 8 bytes a bucket) where the .npz keeps uint32 counts
    assert abs(got["index_artifact_mb"] - want["index_artifact_mb"] - 4 ** 11 * 4 / 1e6) <= 0.2
    assert got["ins_called"] and got["del_called"] and got["trl_called"] and got["warm_equals_cold"]
