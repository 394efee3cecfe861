"""The fetch probe of the port (breakmer_tpu_torch.tools.probe_fetch) on the
CPU: its plain cases run, beside tools/probe_relay_fetch.py loaded by path
and run on the CPU. Every case the JAX probe prints is a case of the
port's, by name; the port then prints one JSON line of every case's
median. Times are the CPU's and are not compared."""

import contextlib
import importlib.util
import io
import json
import re
from pathlib import Path

from breakmer_tpu_torch.tools import probe_fetch

REPO = Path(__file__).resolve().parent.parent
_CASE = re.compile(r"^(\S+)\s+median ")


def _run(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    lines = buf.getvalue().strip().splitlines()
    return [m.group(1) for m in map(_CASE.match, lines) if m], lines


def test_cpu_cases_cover_the_jax_probes_cases():
    spec = importlib.util.spec_from_file_location("jax_tool_probe_relay_fetch",
                                                  REPO / "tools" / "probe_relay_fetch.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    want, _ = _run(jax_tool.main)
    got, lines = _run(lambda: probe_fetch.main(["--device", "cpu"]))
    assert len(want) == 6 and set(want) <= set(got)
    assert len(got) == 3 * 4 + 1 and not any("pinned" in name for name in got)
    rec = json.loads(lines[-1])
    assert rec["metric"] == "fetch_probe" and rec["device"] == "cpu"
    assert list(rec["median_ms"]) == got and all(v > 0 for v in rec["median_ms"].values())
    assert set(rec["n_fetches_over_one_fetch"]) == {"tiny/pageable", "small/pageable",
                                                    "big/pageable"}
