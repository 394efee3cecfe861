"""The germline recheck's junction test (``breakmer_tpu_torch/call/germline.py``)
against its brute-force reference (``svbench/reference/germline.py``: every
normal read on both strands, no candidate selection), on seeded cases: the
port's first carrier is the least (read, strand) that the reference finds,
and None where it finds none. Then the witness of the fault that the test
replaced: on the benchmark's generator at rehearsal depth (20 targets, seed
101) the batched runner with the normal calls dup@chr4:316806, which the
former recheck dropped as germline, and calls no germline SV."""

import json

import numpy as np
import pytest

from breakmer_tpu_torch.call import germline
from breakmer_tpu_torch.encode import ReadBatch, decode_seq
from breakmer_tpu_torch.ops.sw import SWParams
from svbench.reference import germline as reference

K, IDENTITY, PARAMS = 15, 0.85, SWParams()
READ_LEN = 100
KINDS = ("germline", "consensus_error", "one_flank", "small_del")


def _rc(s):
    return (3 - s)[::-1].copy()


def _errors(rng, s, rate):
    """Substitutions at ``rate`` and one-base indels at a tenth of it."""
    out = []
    for c in s:
        u = rng.random()
        if u < rate / 20:
            continue
        if u < rate / 10:
            out.append(int(rng.integers(0, 4)))
        out.append((c + int(rng.integers(1, 4))) % 4 if rng.random() < rate else c)
    return np.asarray(out, dtype=np.int8)


def make_case(seed, kind, strand, err, n_reads=40):
    """(contig, junction_q, normal reads, whether the normal carries the
    junction). ``kind``: "germline" (the normal carries an insertion that
    the contig holds), "consensus_error" (the same with a substitution in
    the contig 5 bases left of the junction), "one_flank" (the contig joins
    the left flank to sequence from elsewhere; the normal carries each part
    alone), "small_del" (the contig lacks 15-40 bases that the normal's
    reads hold between both flanks). ``strand``: the reads as sampled (0),
    reverse-complemented (1) or either at random (2)."""
    rng = np.random.default_rng([seed, KINDS.index(kind), strand])
    left, right, other = (rng.integers(0, 4, 300).astype(np.int8) for _ in range(3))
    mid = rng.integers(0, 4, int(rng.integers(15, 41) if kind == "small_del" else rng.integers(1, 31)))
    mid = mid.astype(np.int8)
    if kind in ("germline", "consensus_error"):
        contig = np.concatenate([left[150:], mid, right[:150]])
        junction_q = [150, 150 + len(mid)]
        if kind == "consensus_error":
            contig[145] = (contig[145] + 1) % 4
        alleles = [np.concatenate([left, mid, right]), np.concatenate([left, right])]
    elif kind == "one_flank":
        contig = np.concatenate([left[150:], other[:150]])
        junction_q = [150]
        alleles = [np.concatenate([left, right]), np.concatenate([right[::-1], other])]
    else:
        contig = np.concatenate([left[150:], right[:150]])
        junction_q = [150]
        alleles = [np.concatenate([left, mid, right])]
    reads = []
    for r in range(n_reads):
        allele = alleles[r % len(alleles)]
        start = int(rng.integers(150, len(allele) - 150 - READ_LEN // 2))
        read = _errors(rng, allele[start:start + READ_LEN], err)
        if strand == 1 or (strand == 2 and rng.random() < 0.5):
            read = _rc(read)
        reads.append(read)
    return decode_seq(contig), junction_q, reads, kind in ("germline", "consensus_error")


def _batch(reads):
    if not reads:
        return ReadBatch(np.zeros((0, READ_LEN), dtype=np.int8), np.zeros(0, dtype=np.int32), [])
    return ReadBatch.from_seqs([decode_seq(r) for r in reads])


CASES = [(seed, kind, strand, err)
         for kind in KINDS for strand in (0, 1, 2) for err in (0.0, 0.03) for seed in (1, 2)]


@pytest.mark.parametrize("seed,kind,strand,err", CASES + [(1, "empty_normal", 0, 0.0)])
def test_the_port_decides_as_the_reference(seed, kind, strand, err):
    if kind == "empty_normal":
        contig, junction_q, _, _ = make_case(seed, "germline", strand, err)
        reads, carrier = [], False
    else:
        contig, junction_q, reads, carrier = make_case(seed, kind, strand, err)
    normal = _batch(reads)
    junction = germline.junction_query(contig, junction_q, K)
    window, a, b = reference.junction_window(contig, junction_q, K)
    assert (junction.query == window).all() and (junction.a, junction.b) == (a, b)
    [hit] = germline.find_carriers([junction], normal, PARAMS, K, IDENTITY, device="cpu")
    want = reference.carriers(window, a, b, normal.codes, normal.lengths, K, IDENTITY, tuple(PARAMS))
    assert (None if hit is None else (hit.read, hit.strand)) == (min(want) if want else None)
    if err == 0.0 or not carrier:  # the scenario's truth
        assert bool(want) == carrier


def test_one_call_decides_every_junction_of_a_region():
    """Several junctions at once give what each gives alone, with one SW
    call and the counts of what it scored and traced back."""
    cases = [make_case(3, kind, 2, 0.01) for kind in KINDS]
    reads = [r for _, _, rs, _ in cases for r in rs]
    normal = _batch(reads)
    junctions = [germline.junction_query(c, jq, K) for c, jq, _, _ in cases]
    counts = {}
    together = germline.find_carriers(junctions, normal, PARAMS, K, IDENTITY, device="cpu", counts=counts)
    alone = [germline.find_carriers([j], normal, PARAMS, K, IDENTITY, device="cpu")[0] for j in junctions]
    assert together == alone
    assert [h is not None for h in together] == [carrier for *_, carrier in cases]
    assert counts["candidates"] >= counts["alignments"] > 0



@pytest.mark.parametrize("normal_carries", [True, False], ids=["germline", "somatic"])
def test_a_junction_with_no_kmer_in_the_normal_is_asked_of_the_normal(normal_carries):
    """A point junction whose contig carries one consensus error at its
    centre: that base is in every k-mer of the k-mer test's window, so none
    is in the normal. The event is germline where a normal read carries the
    junction (a germline deletion), and kept where the normal holds the
    reference only (the same deletion, somatic)."""
    import types

    import torch

    from breakmer_tpu_torch.call.events import SVEvent
    from breakmer_tpu_torch.config import Config
    from breakmer_tpu_torch.io.bed import TargetRegion
    from breakmer_tpu_torch.pipeline import TargetPipeline

    rng = np.random.default_rng(23)
    left, mid, right = (rng.integers(0, 4, n).astype(np.int8) for n in (300, 40, 300))
    reference = np.concatenate([left, mid, right])
    allele = np.concatenate([left, right]) if normal_carries else reference
    starts = rng.integers(150, len(allele) - 150 - READ_LEN // 2, 80)
    normal = _batch([allele[s:s + READ_LEN] for s in starts])
    contig = np.concatenate([left[-60:], right[:60]])
    contig[60] = (contig[60] + 1) % 4  # the first base right of the junction
    ev = SVEvent(sv_type="indel", sv_subtype="D", genes="G", breakpoints=[("chr1", 300, 340)], strands="+",
                 align_cigar="60M40D60M", total_matching=119, mismatches=1, size=40, split_read_count=10,
                 disc_read_count=0, breakpoint_coverages=[10, 10], contig_id="G_contig1",
                 contig_seq=decode_seq(contig), junction_q=[60, 60])
    pipe = TargetPipeline(Config(), TargetRegion("G", "chr1", 0, len(reference), []),
                          types.SimpleNamespace(codes=reference), normal_batch=normal, device=torch.device("cpu"))
    tables = pipe._germline_tables()
    reason, kmers = pipe._germline_kmer_test(ev, tables)
    assert reason is None and kmers[0] == 0 and kmers[1] > 0
    kept = pipe._germline_recheck([ev])
    if normal_carries:
        assert kept == [] and ev.filter_reason.startswith("germline_normal_junction")
    else:
        assert kept == [ev] and ev.filter_reason is None

def _witness(tmp_path, with_normal):
    from breakmer_tpu_torch.config import Config
    from breakmer_tpu_torch.runner import Runner
    from svbench import harness
    from svbench.gen.bam import write_bam
    from svbench.gen.genome import Genome, GenomeSpec, make_panel, write_2bit, write_bed
    from svbench.gen.sample import SampleMaker, make_sample
    from svbench.gen.truth import check_sample

    cfg = harness.rehearsal_config(harness.load_json(harness.PKG / "configs" / "impact_tn.json"))
    cfg["panel"]["targets"] = 20
    mix = harness.load_json(harness.PKG / "traffic" / "sv_dense.json")
    genome = Genome(GenomeSpec.from_config(cfg["genome"]))
    panel = make_panel(genome, cfg["panel"])
    sample = make_sample(SampleMaker(genome, panel, cfg, mix), 101, 0)
    refs = [(c, genome.lengths[c]) for c in genome.names]
    write_bam(tmp_path / "t.bam", refs, sample.tumour, "s0t")
    write_bam(tmp_path / "n.bam", refs, sample.normal, "s0n")
    write_2bit(tmp_path / "genome.2bit", genome)
    write_bed(tmp_path / "targets.bed", panel)
    out = tmp_path / ("tn" if with_normal else "t")
    Runner(Config(analysis_name="s0", analysis_dir=str(out), targets_bed_file=str(tmp_path / "targets.bed"),
                  reference_fasta=str(tmp_path / "genome.2bit"), reference_data_dir=str(tmp_path),
                  sample_bam_file=str(tmp_path / "t.bam"),
                  normal_bam_file=str(tmp_path / "n.bam") if with_normal else None,
                  device="cpu", batch_regions=True, log_level="WARNING")).run()
    metrics = json.loads((out / "metrics.json").read_text())
    return check_sample(sample.svs, out / "output" / "s0.vcf", genome), metrics


def test_the_witness_is_called_with_the_normal(tmp_path):
    got, metrics = _witness(tmp_path, True)
    assert not [m for m in got["missed"] if m.startswith("dup@chr4:316806")]
    assert got["germline"] == 2 and got["germline_called"] == []
    alone, _ = _witness(tmp_path, False)
    assert set(got["missed"]) <= set(alone["missed"])  # the normal drops nothing the tumour alone calls
    counts = metrics["germline"]
    assert counts["events"] == counts["kept"] + counts["germline_by_kmers"] + counts["germline_by_alignment"]
    assert counts["events"] == (counts["germline_by_kmers"] + counts["somatic_by_kmers"]
                                + counts["kmers_inconclusive"])


def test_the_recheck_counts_survive_worker_threads():
    """The batched runner's classify threads add their regions' counts to
    METER at once: none is lost."""
    import sys
    import threading

    from breakmer_tpu_torch.utils.meter import Meter

    meter, interval = Meter(), sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [meter.add_germline({"events": 1, "kept": 2})
                                                    for _ in range(2000)]) for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    counts = meter.snapshot()["germline"]
    assert counts["events"] == 32000 and counts["kept"] == 64000 and counts["alignments"] == 0
