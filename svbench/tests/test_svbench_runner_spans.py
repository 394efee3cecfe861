"""The readers of the runner's spans on small records: each reads its own
span names from the passes' ``stage_s``, over the window's regions, and
gives None where no pass has them (a program without the spans)."""

import importlib

import pytest

OLD = {"bam_decode": 0.5, "extract_clean": 1.0, "kmer_device": 0.25, "assemble": 1.0, "realign": 1.5,
       "classify": 0.25}


def _record(spans: bool) -> dict:
    runner = [{"setup": 0.1, "index_load": 1.0, "region_ref": 0.2, "ledger": 0.3, "finalize": 0.05},
              {"setup": 0.3, "index_load": 0.8, "region_ref": 0.4, "ledger": 0.1, "finalize": 0.15,
               "normal_reads": 0.5}]
    passes = []
    for i, extra in enumerate(runner):
        stage_s = {**OLD, **(extra if spans else {})}
        passes.append({"completed": 100, "wall": sum(OLD.values()) + sum(extra.values()) + 0.01 * (i + 1),
                       "stage_s": stage_s})
    return {"passes": passes}


@pytest.mark.parametrize("name,want", [
    ("index_load_ms_per_region", 1000.0 * 1.8 / 200),
    ("runner_setup_ms_per_region", 1000.0 * 0.4 / 200),
    ("region_ref_ms_per_region", 1000.0 * 0.6 / 200),
    ("output_ms_per_region", 1000.0 * (0.4 + 0.2) / 200),
    ("untraced_ms_per_region", 1000.0 * 0.03 / 200),
])
def test_reader_of_a_runner_span(name, want):
    read = importlib.import_module(f"svbench.metrics.{name}").read
    assert read(_record(True)) == pytest.approx(want, rel=1e-9)
    assert read(_record(False)) is None


def test_the_spans_split_other_ms_per_region():
    from svbench.metrics import other_ms_per_region

    rec = _record(True)
    parts = sum(importlib.import_module(f"svbench.metrics.{n}").read(rec) for n in (
        "index_load_ms_per_region", "runner_setup_ms_per_region", "region_ref_ms_per_region",
        "output_ms_per_region", "untraced_ms_per_region"))
    normal_ms = 1000.0 * 0.5 / 200  # normal_reads: no reader of its own
    assert parts + normal_ms == pytest.approx(other_ms_per_region.read(rec), rel=1e-9)
