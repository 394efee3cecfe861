"""A configuration, a traffic mix, a cell's limits and a per-layer metric
reader dropped into a copy of the benchmark are found by name, with no
file that is there edited."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "svbench", root / "svbench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (root / "svbench").rglob("*") if p.is_file()}
    b = root / "svbench"
    cfg = json.loads((b / "configs" / "oncopanel_t.json").read_text())
    cfg.update(name="newpanel")
    cfg["panel"].update(seed=99, name_prefix="NEW")
    (b / "configs" / "newpanel.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "sv_dense.json").read_text())
    mix.update(name="ins_only", sv_targets_frac=0.5)
    (b / "traffic" / "ins_only.json").write_text(json.dumps(mix))
    (b / "limits" / "newpanel.ins_only.json").write_text(
        (b / "limits" / "oncopanel_t.sv_dense.json").read_text())
    (b / "metrics" / "passes_seen.py").write_text(
        '"""Samples the window ran."""\n\n\ndef read(record):\n    return float(len(record["passes"]))\n')
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "newpanel", "source": "https://example.org/panel",
                             "file": "svbench/configs/newpanel.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "newpanel.ins_only", "config": "newpanel", "traffic": "ins_only",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "passes_seen", "unit": "samples", "better": "higher",
                               "source": "host_clock", "layer": "runner", "moves": "regions_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", "svbench.run", "--rehearse", "--workload", "newpanel.ins_only"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["rehearsal"] == "newpanel.ins_only" and line["correct"] and line["attempted"] == 6
    probe = subprocess.run(
        [sys.executable, "-c", "import json; from svbench import harness; print(json.dumps("
         "harness.read_metrics([('passes_seen', 'samples')], {'passes': [1, 2, 3]})))"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert json.loads(probe.stdout) == {"passes_seen": {"value": 3.0, "unit": "samples"}}
    for p, data in before.items():
        assert p.read_bytes() == data, p
