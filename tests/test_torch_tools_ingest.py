"""The bounded-ingest bench of the port
(breakmer_tpu_torch.tools.bench_bounded_ingest) on the CPU against
tools/bench_bounded_ingest.py, loaded by path, at 0.005 GB of
uncompressed BAM: the same fixture counts and calls from both children
(indexed and preload), equal apart from wall times and RSS."""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path
from unittest import mock

from breakmer_tpu_torch.tools import bench_bounded_ingest

REPO = Path(__file__).resolve().parent.parent
TIMES = {"write_s", "indexed_peak_rss_mb", "indexed_run_s", "preload_peak_rss_mb",
         "preload_run_s"}


def _last_json(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_ingest_equals_the_jax_tool():
    path = REPO / "tools" / "bench_bounded_ingest.py"
    spec = importlib.util.spec_from_file_location("jax_tool_bench_bounded_ingest", path)
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    # its children run ``sys.executable __file__ --child``: the tool's own file
    with mock.patch.object(sys, "argv", [str(path), "0.005"]):
        want = _last_json(jax_tool.main)
    got = _last_json(lambda: bench_bounded_ingest.main(["0.005", "--device", "cpu"]))
    assert {k: v for k, v in got.items() if k not in TIMES} == {
        k: v for k, v in want.items() if k not in TIMES}
    assert set(got) == set(want)
    assert got["calls_identical"] and got["ins_and_del_called"] and got["records"] > 10_000
