"""The tumour/normal cell rehearsed on the CPU with its own limits file:
every check but the share of SVs missed passes (at 6 targets one SV that
the rehearsal's depth leaves uncalled reads 16.7 %), every decision of the
program's germline recheck is the reference's, the matched normal left out
is not correct, and the readers of the normal's spans give numbers there
and None in the tumour-only cells."""

import time

import pytest

from svbench import harness
from svbench.metrics import germline_ms_per_region, normal_reads_ms_per_region
from svbench.reference import germline as reference
from svbench.tests._util import cell

READERS = (germline_ms_per_region, normal_reads_ms_per_region)


def _rehearse(config, mix, **kw):
    return harness.run_cell(cell(config, mix), 2**31 + 3, 0.0, False, t_start=time.time(), rehearse=True, **kw)


def test_the_tumour_normal_cell_passes_its_checks(monkeypatch):
    """... and every alignment decision of the program's germline recheck
    there is the brute-force reference's (svbench/reference/germline.py)."""
    from breakmer_tpu_torch.call import germline

    decisions = []
    find = germline.find_carriers

    def recorded(junctions, normal, params, k, identity, **kw):
        found = find(junctions, normal, params, k, identity, **kw)
        decisions.extend((j, normal, tuple(params), k, identity, h) for j, h in zip(junctions, found))
        return found

    monkeypatch.setattr(germline, "find_carriers", recorded)
    out = _rehearse("impact_tn", "sv_dense")
    checks = out["checks"]
    assert set(checks) == set(harness.load_json(harness.PKG / "limits" / "impact_tn.sv_dense.json"))
    assert all(harness.within(v) for k, v in checks.items() if k != "sv_missed_pct"), checks
    assert out["attempted"] == 6 and out["failed"] == 0
    assert checks["sv_missed_pct"]["value"] <= 100.0 / 6 + 1e-9
    for reader in READERS:
        assert reader.read(out["record"]) > 0
    assert decisions
    for j, normal, params, k, identity, hit in decisions:
        want = reference.carriers(j.query, j.a, j.b, normal.codes, normal.lengths, k, identity, params)
        assert (None if hit is None else (hit.read, hit.strand)) == (min(want) if want else None)


def test_the_normal_left_out_is_not_correct(monkeypatch):
    # 60 targets: the germline SVs (1 in 10) that the normal no longer subtracts pass the limit
    orig = harness.rehearsal_config
    monkeypatch.setattr(harness, "rehearsal_config",
                        lambda cfg: {**orig(cfg), "panel": {**orig(cfg)["panel"], "targets": 60}})
    checks = _rehearse("impact_tn", "sv_dense", fault="normal_left_out")["checks"]
    assert checks["germline_called"]["value"] > checks["germline_called"]["limit"]


@pytest.mark.parametrize("mix", ["sv_dense", "clinical"])
def test_no_normal_no_reading(mix):
    record = _rehearse("oncopanel_t", mix)["record"]
    assert [reader.read(record) for reader in READERS] == [None, None]
