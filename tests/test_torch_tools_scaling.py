"""The panel scaling sweep of the port
(breakmer_tpu_torch.tools.bench_panel_scaling) on the CPU against
tools/bench_panel_scaling.py, loaded by path: one point, 20 genes at
read_step 6 with 100 bp reads, CPU column only (--device cpu), each in
its tool's own subprocess. The point's counts (targets, records, calls)
are equal; every other number is a wall time."""

import importlib.util
import json
from pathlib import Path

from breakmer_tpu_torch.tools import bench_panel_scaling

REPO = Path(__file__).resolve().parent.parent
COUNTS = ("records", "calls")
TIMES = ("cold_s", "warm_s", "warm_s_all", "regions_per_s", "reads_per_s")


def test_one_point_cpu_column_equals_the_jax_tool(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location("jax_tool_bench_panel_scaling",
                                                  REPO / "tools" / "bench_panel_scaling.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    want = jax_tool.run_sub("cpu", 20, 6, 100)

    monkeypatch.setattr(bench_panel_scaling, "SIZES", [20])
    monkeypatch.setattr(bench_panel_scaling, "DEEP_TIERS", [])
    out = tmp_path / "scaling.json"
    bench_panel_scaling.main([str(out), "--device", "cpu"])
    got = json.loads(out.read_text())
    assert got["metric"] == "panel_scaling_cpu_vs_cuda"
    [point] = got["points"]
    assert set(point) == {"n_genes", "read_step", "read_len", "cpu"}
    assert (point["n_genes"], point["read_step"], point["read_len"]) == (20, 6, 100)
    assert set(point["cpu"]) == set(COUNTS + TIMES)
    assert {k: point["cpu"][k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert want["targets"] == 20 and want["calls"] > 0
    assert got["crossover"]["first_cuda_win"] is None
