"""How ``correct`` is decided, rehearsed on the CPU at a tiny size: every
mix of every cell runs through Runner and passes its checks; the control
(the reference at the precision below, in the program's place), each
fault planted under the timed path and a layer whose calls the benchmark
no longer sees come out not correct."""

import time

import pytest

from svbench import harness
from svbench.tests._util import cell

CELLS = [("oncopanel_t", "sv_dense"), ("oncopanel_t", "clinical")]
# The tumour/normal configuration has no cell (its germline recheck drops
# somatic SVs that it guarantees), so these tests hold its path to these
# limits, which leave out the share of SVs missed.
TN_LIMITS = {"region_errors": 0, "germline_called": 4, "kmer_sets_wrong": 0, "sw_pairs_wrong": 0,
             "sw_calls_checked": {"at_least": 1}, "kmer_sets_checked": {"at_least": 1}}


def _run(config, mix, targets=None, monkeypatch=None, **kw):
    if targets:
        orig = harness.rehearsal_config
        monkeypatch.setattr(harness, "rehearsal_config",
                            lambda cfg: {**orig(cfg), "panel": {**orig(cfg)["panel"], "targets": targets}})
    if config == "impact_tn":
        monkeypatch.setattr(harness, "cell_files", lambda c: (*_tn_files(c), TN_LIMITS))
    out = harness.run_cell(cell(config, mix), 2**31 + 3, 0.0, False, t_start=time.time(), rehearse=True, **kw)
    ok = all(harness.within(v) for v in out["checks"].values())
    return ok, out


def _tn_files(c):
    cfg = harness.load_json(harness.PKG / "configs" / f"{c['config']}.json")
    return cfg, harness.load_json(harness.PKG / "traffic" / f"{c['traffic']}.json")


@pytest.mark.parametrize("config,mix", CELLS)
def test_each_mix_runs_through_runner_and_passes(config, mix):
    ok, out = _run(config, mix)
    assert ok, out["checks"]
    assert out["attempted"] == 6 and out["failed"] == 0
    assert out["checks"]["kmer_sets_checked"]["value"] >= 1 and out["checks"]["sw_calls_checked"]["value"] >= 1


@pytest.mark.parametrize("config,control,number", [
    ("oncopanel_t", "kmer_table_16", "kmer_sets_wrong"), ("impact_tn", "kmer_table_16", "kmer_sets_wrong"),
    ("oncopanel_t", "pos_16bit", "sv_missed_pct"),
])
def test_the_control_is_not_correct(config, control, number, monkeypatch):
    ok, out = _run(config, "sv_dense", control=control, monkeypatch=monkeypatch)
    assert not ok and out["checks"][number]["value"] > out["checks"][number]["limit"]


@pytest.mark.parametrize("config,fault,number", [
    ("oncopanel_t", "sw_answer", "sw_pairs_wrong"),
    ("oncopanel_t", "sw_half", "sw_pairs_wrong"),
    ("oncopanel_t", "kmer_half", "kmer_sets_wrong"),
    ("oncopanel_t", "kmer_answer", "kmer_sets_wrong"),
    ("oncopanel_t", "region_raises", "region_errors"),
    ("impact_tn", "sw_half", "sw_pairs_wrong"),
    ("impact_tn", "kmer_half", "kmer_sets_wrong"),
    ("impact_tn", "kmer_answer", "kmer_sets_wrong"),
    ("impact_tn", "normal_left_out", "germline_called"),
])
def test_a_fault_under_the_timed_path_is_not_correct(config, fault, number, monkeypatch):
    # 60 targets: enough germline SVs (1 in 10) to pass the limit when the normal is left out
    ok, out = _run(config, "sv_dense", targets=60 if fault == "normal_left_out" else None, fault=fault,
                   monkeypatch=monkeypatch)
    assert not ok, (fault, out["checks"])
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


@pytest.mark.parametrize("config,fault,number", [
    ("oncopanel_t", "sw_unhooked", "sw_calls_checked"),
    ("oncopanel_t", "kmer_unhooked", "kmer_sets_checked"),
    ("impact_tn", "kmer_unhooked", "kmer_sets_checked"),
])
def test_a_layer_the_benchmark_no_longer_sees_is_not_correct(config, fault, number, monkeypatch):
    ok, out = _run(config, "sv_dense", fault=fault, monkeypatch=monkeypatch)
    assert not ok, (fault, out["checks"])
    assert out["checks"][number]["value"] == 0
    assert all(harness.within(v) for k, v in out["checks"].items() if k != number)
