"""The accuracy tools of the port (breakmer_tpu_torch.tools.sweep_accuracy,
sweep_envelope, triage_scenario) on the CPU against the JAX tools of
tools/, loaded by path: the same seeds at each tool's smallest setting
(the envelope's read-step axis cut to two steps, in both modules) give
records equal apart from wall_s, and the same triage lines apart from
wall seconds. Both packages run on the CPU."""

import contextlib
import importlib.util
import io
import json
import re
from pathlib import Path
from unittest import mock

import pytest

from breakmer_tpu_torch.tools import sweep_accuracy, sweep_envelope, triage_scenario

REPO = Path(__file__).resolve().parent.parent


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def records(name, port, args, tmp_path, patch=None):
    """(JAX record, port record) of ``args``, each without wall_s; ``patch``
    maps module constants to values set in both modules."""
    jax_tool = load_jax_tool(name)
    out = {}
    with contextlib.ExitStack() as stack:
        for key, value in (patch or {}).items():
            for mod in (jax_tool, port):
                stack.enter_context(mock.patch.object(mod, key, value))
        with mock.patch("sys.argv", [f"{name}.py", *args, "--out", str(tmp_path / "jax.json")]):
            jax_tool.main()
        port.main([*args, "--out", str(tmp_path / "port.json"), "--device", "cpu"])
    for side in ("jax", "port"):
        out[side] = json.loads((tmp_path / f"{side}.json").read_text())
        out[side].pop("wall_s")
    return out["jax"], out["port"]


def test_sweep_accuracy_repeats_equals_the_jax_tool(tmp_path):
    want, got = records("sweep_accuracy", sweep_accuracy,
                        ["--genome", "repeats", "--seeds", "2", "--fp", "1"], tmp_path)
    assert got == want
    assert sum(v["n"] for v in got["recall"].values()) >= 8 and got["fp"]["regions"] == 4
    assert "recall_by_context" in got and got["filters"]["recall_panels"]["prefilter_events"] > 0


def test_sweep_envelope_equals_the_jax_tool(tmp_path):
    want, got = records("sweep_envelope", sweep_envelope,
                        ["--seeds", "2", "--sub-rates", "0.04", "--profile", "tuned"],
                        tmp_path, patch={"STEPS": [25, 33]})
    assert got == want
    assert [c["read_step"] for c in got["cells"]] == [25, 33]


def test_triage_prints_the_jax_tools_lines():
    jax_tool = load_jax_tool("triage_scenario")
    out = {}
    for side in ("jax", "port"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if side == "jax":
                with mock.patch("sys.argv", ["triage_scenario.py", "3"]):
                    assert jax_tool.main() == 0
            else:
                assert triage_scenario.main(["3", "--device", "cpu"]) == 0
        # a region's stats hold its wall seconds
        out[side] = re.sub(r"'(\w+_s)': [0-9.e+-]+", r"'\1': T", buf.getvalue())
    assert out["port"] == out["jax"]
    assert out["port"].count("\n== G") >= 4 and "   ev: " in out["port"]


@pytest.mark.parametrize("flags,name", [
    ([], "ACCURACY_r05.json"),
    (["--genome", "repeats"], "ACCURACY_REPEATS_r05.json"),
    (["--extremes", "--polymorphism"], "ACCURACY_EXTREMES_POLY_r05.json"),
    (["--sub-rate", "0.02"], "ACCURACY_STRESS_r05.json"),
])
def test_sweep_accuracy_default_out_keeps_the_jax_name_under_build(flags, name):
    assert Path(sweep_accuracy.parse_args(flags).out) == REPO / "build" / "tools" / name
