"""The port's METER spans cover a sample's wall on the serial path: set-up,
the index load, each region's reference, the normal's reads and ledger,
and the output, beside the six stages of the regions' work and, with a
normal, the germline recheck, with no span open inside another. ``cli run --profile`` puts every stage on the
profiler's timeline as a ``breakmer.<stage>`` range; outside it the meter
opens no profiler range."""

import gc
import json
import time
from contextlib import contextmanager
from pathlib import Path

import pytest

from breakmer_tpu_torch import vcf
from breakmer_tpu_torch.align.index import GenomeIndex
from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.pipeline import TargetPipeline
from breakmer_tpu_torch.runner import Runner
from breakmer_tpu_torch.testing.scenarios import build_scenario
from breakmer_tpu_torch.utils.meter import METER

RUNNER_SPANS = {"setup", "index_load", "region_ref", "ledger", "finalize"}
REGION_STAGES = {"bam_decode", "extract_clean", "kmer_device", "assemble", "realign", "classify"}


def _config(tmp_path, normal, batched=False, **extra):
    (tmp_path / "in").mkdir()
    cfg_kwargs, _ = build_scenario(1, tmp_path / "in", n_genes=3, kinds=["ins", "del", "inv"],
                                   with_normal_germline=normal)
    cfg_kwargs.update(batch_regions=batched, device="cpu", log_level="WARNING",
                      analysis_dir=str(tmp_path / "out"), **extra)
    return cfg_kwargs


def _metrics(cfg_kwargs):
    with open(f"{cfg_kwargs['analysis_dir']}/metrics.json") as fh:
        return json.load(fh)


class _Spans:
    """METER.stage wrapped: every span's (name, start, end), and the names
    open at each moment."""

    def __init__(self, monkeypatch):
        self.log, self.open = [], []
        stage = METER.stage

        @contextmanager
        def logged(name):
            self.open.append(name)
            with stage(name):
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    self.log.append((name, t0, time.perf_counter()))
                    self.open.pop()

        monkeypatch.setattr(METER, "stage", logged)

    def probe(self, monkeypatch, owner, attr, span):
        """``owner.attr`` notes the spans open at each call; the returned
        check holds when it was called, each time inside ``span`` alone."""
        orig = getattr(owner, attr)  # a class method comes bound to its class
        calls = []

        def probed(*a, **kw):
            calls.append(list(self.open))
            return orig(*a, **kw)

        monkeypatch.setattr(owner, attr, probed)
        return lambda: bool(calls) and all(c == [span] for c in calls)


@contextmanager
def _no_collection():
    """Two clocks around one span are compared: a collection that falls
    between them would land on one side only."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


@pytest.mark.parametrize("normal", [False, True], ids=["tumour", "tumour_normal"])
def test_serial_spans_reach_metrics_and_never_overlap(tmp_path, monkeypatch, normal):
    _spans_reach_metrics_and_never_overlap(tmp_path, monkeypatch, normal, False)


def test_batched_spans_with_a_normal_reach_metrics_and_never_overlap(tmp_path, monkeypatch):
    """The batched path opens the six region stages too, and the recheck's."""
    stage_s = _spans_reach_metrics_and_never_overlap(tmp_path, monkeypatch, True, True)
    assert REGION_STAGES - {"bam_decode"} <= set(stage_s)


def _spans_reach_metrics_and_never_overlap(tmp_path, monkeypatch, normal, batched):
    cfg_kwargs = _config(tmp_path, normal, batched)
    spans = _Spans(monkeypatch)
    with _no_collection():
        Runner(Config(**cfg_kwargs)).run()
    stage_s = _metrics(cfg_kwargs)["stage_s"]
    want = RUNNER_SPANS | ({"normal_reads", "germline"} if normal else set())
    assert want <= set(stage_s)
    assert ("normal_reads" in stage_s) == ("germline" in stage_s) == normal
    assert set(stage_s) <= want | REGION_STAGES
    assert {n for n, _, _ in spans.log} == set(stage_s)
    ordered = sorted(spans.log, key=lambda s: s[1])
    for (a, _, a1), (b, b0, _) in zip(ordered, ordered[1:]):
        assert a1 <= b0, f"{b} opens inside {a}"
    for name, secs in stage_s.items():
        logged = sum(t1 - t0 for n, t0, t1 in spans.log if n == name)
        assert abs(logged - secs) <= 1e-3 + 0.05 * secs, name
    return stage_s


@pytest.mark.parametrize("normal", [False, True], ids=["tumour", "tumour_normal"])
def test_each_runner_call_runs_inside_its_own_span(tmp_path, monkeypatch, normal):
    cfg_kwargs = _config(tmp_path, normal)
    Runner(Config(**{**cfg_kwargs, "analysis_dir": str(tmp_path / "cache")})).setup()  # the index cache
    spans = _Spans(monkeypatch)
    checks = {
        "index_load": spans.probe(monkeypatch, GenomeIndex, "load", "index_load"),
        "region_ref": spans.probe(monkeypatch, Runner, "region_ref", "region_ref"),
        "ledger": spans.probe(monkeypatch, Runner, "_append_ledger", "ledger"),
        "finalize": spans.probe(monkeypatch, vcf, "write_vcf", "finalize"),
    }
    if normal:
        checks["normal_reads"] = spans.probe(monkeypatch, Runner, "_normal_batch", "normal_reads")
        checks["germline"] = spans.probe(monkeypatch, TargetPipeline, "_germline_recheck", "germline")
    Runner(Config(**cfg_kwargs)).run()
    assert {name: ok() for name, ok in checks.items()} == {name: True for name in checks}


@pytest.mark.parametrize("source", ["sam", "bam"])
def test_metrics_count_the_sample_reads(tmp_path, source):
    """``metrics.json``'s ``sample_reads``: every record of the sample
    ingested, a share of them gathered (each row once) and the inflated
    stream's MB, where there is one."""
    from breakmer_tpu_torch.io.bam import write_bam
    from breakmer_tpu_torch.io.sam import parse_sam_line

    cfg_kwargs = _config(tmp_path, False)
    lines = Path(cfg_kwargs["sample_bam_file"]).read_text().splitlines()
    records = [parse_sam_line(x) for x in lines if x and not x.startswith("@")]
    if source == "bam":
        refs = [(x.split("SN:")[1].split("\t")[0], int(x.split("LN:")[1]))
                for x in lines if x.startswith("@SQ")]
        cfg_kwargs["sample_bam_file"] = str(tmp_path / "in" / "sample.bam")
        write_bam(cfg_kwargs["sample_bam_file"], refs, records)
    Runner(Config(**cfg_kwargs)).run()
    got = _metrics(cfg_kwargs)["sample_reads"]
    assert list(got) == ["records", "rows_gathered", "inflated_mb"]
    assert got["records"] == len(records) > 0
    assert 0 < got["rows_gathered"] <= got["records"]
    assert (got["inflated_mb"] > 0) == (source == "bam")


def test_set_up_spans_survive_the_cli_order_and_a_run_meters_itself(tmp_path):
    cfg_kwargs = _config(tmp_path, False)
    runner = Runner(Config(**cfg_kwargs))
    runner.setup()
    runner.run()
    first = _metrics(cfg_kwargs)["stage_s"]
    assert {"setup", "index_load"} <= set(first)
    runner.run()  # the same Runner again: its set-up was the first run's
    again = _metrics(cfg_kwargs)["stage_s"]
    assert not {"setup", "index_load"} & set(again) and {"region_ref", "finalize"} <= set(again)
    other = Runner(Config(**{**cfg_kwargs, "analysis_dir": str(tmp_path / "other")}))
    runner2 = Runner(Config(**{**cfg_kwargs, "analysis_dir": str(tmp_path / "second")}))
    runner2.setup()
    other.setup()  # another sample's set-up after runner2's
    runner2.run()
    with open(tmp_path / "second" / "metrics.json") as fh:
        assert not {"setup", "index_load"} & set(json.load(fh)["stage_s"])


def test_cli_profile_labels_every_stage_on_the_trace(tmp_path):
    from breakmer_tpu_torch.cli import main

    cfg_kwargs = _config(tmp_path, True)
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps(cfg_kwargs))
    with _no_collection():
        assert main(["run", str(cfg_file), "--profile"]) == 0
    assert METER.profile is False
    stage_s = _metrics(cfg_kwargs)["stage_s"]
    trace = json.loads((tmp_path / "out" / "trace" / "trace.json").read_text())
    ranges = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("breakmer."):
            name = e["name"][len("breakmer."):]
            ranges[name] = ranges.get(name, 0.0) + e["dur"] / 1e6
    assert set(ranges) == set(stage_s) and RUNNER_SPANS | {"normal_reads", "germline"} <= set(ranges)
    for name, secs in stage_s.items():
        assert abs(ranges[name] - secs) <= max(0.05 * secs, 0.002), (name, ranges[name], secs)


def test_a_profiler_the_runner_did_not_start_sees_no_stage_range(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    cfg_kwargs = _config(tmp_path, False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        Runner(Config(**cfg_kwargs)).run()
    names = {e.name for e in prof.events()}
    assert names  # the profiler recorded the run
    assert not [n for n in names if n.startswith("breakmer.")]
    assert RUNNER_SPANS <= set(_metrics(cfg_kwargs)["stage_s"])
