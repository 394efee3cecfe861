"""The agreement tool (breakmer_tpu_torch.tools.gpu_agreement) on the CPU,
against tools/tpu_agreement.py: its pad-tier cases hand the kernel the
same arrays as the JAX tool hands sw_score_pallas (recorded by running
the JAX tool with its kernel, its oracle and its backend check patched;
the tool's file is unchanged), its long cases straddle every strip
boundary of the CUDA kernel, and its record has the JAX record's form.
Exact: integer arrays, dtypes included."""

import importlib.util
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest

import breakmer_tpu.ops.sw as jax_sw
import breakmer_tpu.ops.sw_pallas as jax_sw_pallas
from breakmer_tpu_torch.tools import gpu_agreement

REPO = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_kernel_inputs():
    """[(q, t, no_n, target_chunk)] for every sw_score_pallas call the JAX
    tool makes, in order."""
    calls = []

    def zeros(q, *args, **kw):
        z = np.zeros(q.shape[0], np.int32)
        return z, z, z

    def pallas(q, t, params, no_n=False, target_chunk=None, **kw):
        calls.append((np.asarray(q), np.asarray(t), no_n, target_chunk))
        return zeros(q)

    tool = _load("tpu_agreement")
    with mock.patch.object(jax, "default_backend", lambda: "tpu"), \
            mock.patch.object(jax_sw_pallas, "sw_score_pallas", pallas), \
            mock.patch.object(jax_sw, "sw_score", zeros), \
            mock.patch("sys.argv", ["tpu_agreement.py"]):
        assert tool.main() == 0
    return calls


def test_pad_tier_arrays_equal_the_jax_tools():
    want = _jax_kernel_inputs()
    cases = gpu_agreement.build_cases(np.random.default_rng(gpu_agreement.SEED))
    got = [(q, t, no_n) for _, paths, _ in cases[:len(gpu_agreement.PAD_SHAPES)]
           for _, q, t, no_n in paths]
    assert len(got) == 12 and len(want) == 12 + len(gpu_agreement.LONG_SHAPES)
    for (q, t, no_n), (wq, wt, wno_n, chunk) in zip(got, want):
        assert chunk is None and no_n == wno_n
        for a, b in ((q, wq), (t, wt)):
            assert a.dtype == b.dtype == np.int8 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # the long cases keep the JAX tool's shapes
    assert [(q.shape[0], q.shape[1], t.shape[1]) for q, t, _, _ in want[12:]] == [
        (B, Lq, Lt) for B, Lq, Lt in gpu_agreement.LONG_SHAPES]


@pytest.mark.parametrize("R", [4, 8])
@pytest.mark.parametrize("shape", gpu_agreement.LONG_SHAPES, ids=str)
def test_long_cases_straddle_every_strip_boundary(shape, R):
    cases = gpu_agreement.build_cases(np.random.default_rng(gpu_agreement.SEED))
    name = f"strips {shape[0]}x({shape[1]}x{shape[2]})"
    _, [(_, q, t, no_n)], hits = next(c for c in cases if c[0] == name)
    B, Lq, Lt = shape
    assert q.shape == (B, Lq) and t.shape == (B, Lt) and not no_n
    bounds = [32 * R * k for k in range(1, -(-Lq // (32 * R)))]
    assert set(bounds) <= set(gpu_agreement.strip_boundaries(Lq))
    for bd in bounds:
        assert any(s < bd < e for _, s, e, _ in hits), bd
        assert (q[1, bd - 4:bd + 4] == 4).all()  # an N run on the boundary
    for row, s, e, j0 in hits:  # each hit is in the target (row 2 after % 2)
        np.testing.assert_array_equal(t[row, j0:j0 + e - s], q[row, s:e])
    assert q[2].max() <= 1 and t[2].max() <= 1  # the tie-heavy row


def test_record_has_the_jax_records_form(tmp_path, monkeypatch):
    """The CPU rehearsal (plain against plain) at one shape of each kind
    writes a record with AGREEMENT_r05.json's keys."""
    import json

    monkeypatch.setattr(gpu_agreement, "PAD_SHAPES", [(8, 128, 256)])
    monkeypatch.setattr(gpu_agreement, "LONG_SHAPES", [(8, 256, 512)])
    out = tmp_path / "agreement.json"
    assert gpu_agreement.main(["--device", "cpu", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    ref = json.loads((REPO / "AGREEMENT_r05.json").read_text())
    assert set(got) == set(ref) and set(got["cases"][0]) == set(ref["cases"][0])
    assert got["backend"] == "cpu" and got["mismatches"] == 0 and got["agreement"] is True
    assert [c["case"] for c in got["cases"]] == ["8x(128x256)", "strips 8x(256x512)"]
