"""The matched normal's region reads as columns through its index
(``breakmer_tpu_torch/io/bam_columns.py``): ``BamColumnReader.fetch_columns``
keeps exactly the records that ``BamIndexedReader.fetch`` yields, in its
order, from BAI and CSI indexes alike; ``Runner._normal_batch`` builds the
same batch from them as from the records; SAM text, an unindexed BAM and a
run without the native library keep the record path, and METER counts
which path served each region. A tumour/normal scenario gives the same
svs.out and VCF with its normal as sorted SAM text and as an indexed BAM,
serially and batched."""

import json

import numpy as np
import pytest

from breakmer_tpu_torch import native
from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.encode import encode_seq
from breakmer_tpu_torch.io.bam import BamIndexedReader, _bgzf_read_block, write_bam
from breakmer_tpu_torch.io.bam_columns import BamColumnReader, column_qnames
from breakmer_tpu_torch.io.bed import TargetRegion
from breakmer_tpu_torch.io.sam import SamRecord, parse_sam_line
from breakmer_tpu_torch.reads import NormalReads
from breakmer_tpu_torch.runner import Runner
from breakmer_tpu_torch.utils.meter import METER

REFS = [("chr1", 300_000), ("chr2", 50_000), ("chr3", 20_000)]
IUPAC = "ACGTNRYKMSWBDHV="
# (name, chrom, start, end): a chromosome's start, its middle, a stretch
# with no reads, one spanning many BGZF blocks, another chromosome, one
# with no reads at all and one missing from the header
REGIONS = [
    ("start", "chr1", 0, 700),
    ("middle", "chr1", 51_000, 55_000),
    ("empty", "chr1", 260_000, 262_000),
    ("many_blocks", "chr1", 20_000, 140_000),
    ("chr2", "chr2", 10_000, 14_000),
    ("no_reads", "chr3", 0, 20_000),
    ("absent", "chrX", 0, 1_000),
]


def _records(seed=3):
    """Coordinate-sorted records over chr1 and chr2: odd lengths, IUPAC and
    N bases, soft clips, insertions, short and long deletions (the long
    ones land in the index's higher bins), placed-unmapped mates,
    secondaries and supplementaries without a sequence, duplicates, reads
    without qualities, then unplaced unmapped reads."""
    rng = np.random.default_rng(seed)
    recs = []
    for chrom, span, n in (("chr1", 200_000, 7_000), ("chr2", 30_000, 800)):
        for i, pos in enumerate(np.sort(rng.integers(0, span, n))):
            length = int(rng.integers(15, 152))
            bases = rng.choice(list("ACGT"), length)
            odd = rng.random(length) < 0.03
            bases[odd] = rng.choice(list(IUPAC), int(odd.sum()))
            seq, flag, cigar = "".join(bases), 0, [(length, "M")]
            kind = rng.random()
            if kind < 0.08:
                clip = int(rng.integers(1, length // 2 + 1))
                cigar = [(clip, "S"), (length - clip, "M")]
            elif kind < 0.14:
                cut = int(rng.integers(1, length))
                cigar = [(cut, "M"), (int(rng.integers(1, 40)), "D"), (length - cut, "M")]
            elif kind < 0.16:
                cut = int(rng.integers(1, length))
                cigar = [(cut, "M"), (int(rng.integers(20_000, 40_000)), "D"), (length - cut, "M")]
            elif kind < 0.2 and length > 4:
                cigar = [(length - 3, "M"), (2, "I"), (1, "M")]
            elif kind < 0.24:
                flag, cigar = 0x4 | 0x1, []  # placed at its mate
            elif kind < 0.28:
                flag, seq = 0x100, "*"
            elif kind < 0.31:
                flag, seq = 0x800, "*"
            elif kind < 0.36:
                flag = 0x400
            qual = [] if rng.random() < 0.3 or seq == "*" else \
                rng.integers(2, 41, len(seq)).tolist()
            recs.append(SamRecord(qname=f"{chrom}r{i}", flag=flag, rname=chrom, pos=int(pos), mapq=60,
                                  cigar=cigar, rnext="=", pnext=int(pos), tlen=0, seq=seq, qual=qual))
    for i in range(5):
        recs.append(SamRecord(qname=f"u{i}", flag=0x4, rname="*", pos=-1, mapq=0, cigar=[], rnext="*",
                              pnext=-1, tlen=0, seq="ACGTN"[: i + 1], qual=[]))
    return recs


@pytest.fixture(scope="module", params=["bai", "csi"])
def indexed_bam(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(request.param) / "normal.bam"
    write_bam(path, REFS, _records(), index=request.param)
    return path


@pytest.mark.parametrize("region", REGIONS, ids=[r[0] for r in REGIONS])
def test_fetch_columns_keeps_what_fetch_yields(indexed_bam, region):
    _, chrom, start, end = region
    with BamIndexedReader(indexed_bam) as reader:
        want = list(reader.fetch(chrom, start, end))
    with BamColumnReader(indexed_bam) as reader:
        cols = reader.fetch_columns(chrom, start, end)
    assert cols["n"] == len(want)
    assert cols["decoded"] >= cols["n"]
    if region[0] in ("no_reads", "absent"):
        assert cols["decoded"] == 0
    if not want:
        return
    assert column_qnames(cols["names"]) == [r.qname for r in want]
    for key, attr in (("pos", "pos"), ("flag", "flag"), ("mapq", "mapq"), ("tlen", "tlen"),
                      ("next_pos", "pnext")):
        assert cols[key].tolist() == [getattr(r, attr) for r in want], key
    assert (cols["pos"] + cols["ref_span"]).tolist() == [r.reference_end() for r in want]
    assert cols["n_cigar"].tolist() == [len(r.cigar) for r in want]
    seqs = ["" if r.seq == "*" else r.seq for r in want]
    assert cols["lseq"].tolist() == [len(s) for s in seqs]
    for i, s in enumerate(seqs):
        assert np.array_equal(cols["seq_codes"][i, : len(s)], encode_seq(s)), want[i].qname
        assert (cols["seq_codes"][i, len(s):] == 4).all()


def test_the_regions_cover_what_the_records_need(indexed_bam):
    """The cases are what they claim: one region spans many BGZF blocks and
    several chunks; the regions hold IUPAC bases, reads without sequence,
    placed-unmapped reads and reads straddling both edges."""
    with BamColumnReader(indexed_bam) as reader:
        rid = reader._ref_id("chr1")
        chunks = reader.index.query(rid, 20_000, 140_000)
        blocks = [b for b in _block_offsets(indexed_bam) if chunks[0][0] >> 16 <= b <= chunks[-1][1] >> 16]
        assert len(chunks) > 1 and len(blocks) > 8
        got = [list(reader.fetch("chr1", s, e)) for _, c, s, e in REGIONS[:4]]
    recs = [r for rs in got for r in rs]
    assert any(r.seq == "*" for r in recs) and any(r.is_unmapped for r in recs)
    assert any(set(r.seq) - set("ACGT*") for r in recs)
    for (_, _, s, e), rs in zip(REGIONS[1:2], got[1:2]):
        assert any(r.pos < s < r.reference_end() for r in rs)
        assert any(r.pos < e < r.reference_end() for r in rs)


def _block_offsets(path):
    offsets, off = [], 0
    with open(path, "rb") as fh:
        while True:
            _, size = _bgzf_read_block(fh, off)
            if not size:
                return offsets
            offsets.append(off)
            off += size


def _runner(normal, **kw):
    return Runner(Config(normal_bam_file=str(normal), region_buffer=200, **kw))


def _target(chrom, start, end):
    return TargetRegion(name="t", chrom=chrom, start=start, end=end, intervals=[])


@pytest.mark.parametrize("region", REGIONS, ids=[r[0] for r in REGIONS])
def test_normal_batch_from_columns_equals_the_record_path(indexed_bam, region):
    target = _target(*region[1:])
    METER.reset()
    got = _runner(indexed_bam)._normal_batch(target)
    assert METER.normal_reads["regions_columnar"] == 1 and METER.normal_reads["regions_records"] == 0
    records = _runner(indexed_bam)
    records.normal_reads = NormalReads(records.cfg, None)  # as without an index or the native library
    want = records._normal_batch(target)
    assert METER.normal_reads["regions_records"] == 1
    assert (got is None) == (want is None)
    if want is None:
        return
    assert METER.normal_reads["reads_kept"] == 2 * len(want)
    assert got.codes.dtype == want.codes.dtype and np.array_equal(got.codes, want.codes)
    assert got.codes.base is None or got.codes.base.size == got.codes.size  # no view of a chunk
    assert got.lengths.dtype == want.lengths.dtype and np.array_equal(got.lengths, want.lengths)
    assert got.names == want.names and got.quals is None and want.quals is None


def test_sam_unindexed_and_no_native_take_the_record_path(indexed_bam, tmp_path, monkeypatch):
    recs = _records()
    sam = tmp_path / "normal.sam"
    sam.write_text("".join(f"@SQ\tSN:{c}\tLN:{n}\n" for c, n in REFS) + "".join(
        "\t".join([r.qname, str(r.flag), r.rname, str(r.pos + 1), str(r.mapq),
                   "".join(f"{n}{op}" for n, op in r.cigar) or "*", r.rnext, str(r.pnext + 1),
                   str(r.tlen), r.seq, "*"]) + "\n" for r in recs))
    assert parse_sam_line(sam.read_text().splitlines()[len(REFS)]).qname == recs[0].qname
    unindexed = tmp_path / "unindexed.bam"
    write_bam(unindexed, REFS, recs)
    target = _target("chr1", 51_000, 55_000)
    want = _runner(indexed_bam)._normal_batch(target)
    for normal in (sam, unindexed):
        METER.reset()
        got = _runner(normal)._normal_batch(target)
        assert dict(METER.normal_reads) == {"regions_records": 1, "reads_kept": len(want)}, normal
        assert np.array_equal(got.codes, want.codes) and got.names == want.names
    monkeypatch.setattr(native, "available", lambda: False)
    METER.reset()
    got = _runner(indexed_bam)._normal_batch(target)
    assert METER.normal_reads["regions_records"] == 1 and METER.normal_reads["regions_columnar"] == 0
    assert np.array_equal(got.codes, want.codes) and got.names == want.names


def test_the_reader_is_parsed_once_and_closed_after_a_run(indexed_bam, monkeypatch):
    opened = []
    init = BamColumnReader.__init__

    def counted(self, *a, **kw):
        opened.append(self)
        init(self, *a, **kw)

    monkeypatch.setattr(BamColumnReader, "__init__", counted)
    runner = _runner(indexed_bam)
    for start in range(0, 100_000, 10_000):
        runner._normal_batch(_target("chr1", start, start + 3_000))
    assert len(opened) == 1 and runner.normal_reads.reader is opened[0]
    monkeypatch.setattr(Runner, "_run_serial", lambda self, resume: [])
    runner.targets = {"t": _target("chr1", 0, 100)}
    runner.run()
    assert opened[0]._fh.closed and runner.normal_reads is None


def _sorted_normal(cfg_kwargs, work):
    """The scenario's normal as coordinate-sorted SAM text and as an
    indexed BAM of the same records, in the same order."""
    lines = open(cfg_kwargs["normal_bam_file"]).read().splitlines()
    header = [x for x in lines if x.startswith("@")]
    refs = [(f.split("SN:")[1].split("\t")[0], int(f.split("LN:")[1])) for f in header]
    order = {c: i for i, (c, _) in enumerate(refs)}
    body = [x for x in lines if x and not x.startswith("@")]
    recs = [parse_sam_line(x) for x in body]
    keyed = sorted(range(len(recs)), key=lambda i: (order.get(recs[i].rname, len(refs)), recs[i].pos))
    sam = work / "normal_sorted.sam"
    sam.write_text("\n".join(header + [body[i] for i in keyed]) + "\n")
    bam = work / "normal.bam"
    write_bam(bam, refs, [recs[i] for i in keyed], index="bai")
    return sam, bam


@pytest.mark.parametrize("batched", [False, True], ids=["serial", "batched"])
def test_a_tumour_normal_run_is_the_same_with_an_indexed_bam_normal(tmp_path, batched):
    from breakmer_tpu_torch.testing.scenarios import build_scenario

    work = tmp_path / "in"
    work.mkdir()
    cfg_kwargs, _ = build_scenario(1, work, n_genes=3, kinds=["ins", "del", "inv"], with_normal_germline=True)
    sam, bam = _sorted_normal(cfg_kwargs, work)
    out = {}
    for name, normal in (("sam", sam), ("bam", bam)):
        kw = dict(cfg_kwargs, batch_regions=batched, device="cpu", log_level="WARNING",
                  analysis_dir=str(tmp_path / name), normal_bam_file=str(normal))
        runner = Runner(Config(**kw))
        runner.run()
        metrics = json.loads((tmp_path / name / "metrics.json").read_text())
        files = sorted((tmp_path / name / "output").iterdir())
        out[name] = (runner, metrics, {f.name: f.read_bytes() for f in files})
    assert out["sam"][2] == out["bam"][2] and any(n.endswith(".vcf") for n in out["bam"][2])
    regions = len(out["bam"][0].targets)
    assert out["bam"][1]["normal_reads"]["regions_columnar"] == regions == 4
    assert out["bam"][1]["normal_reads"]["regions_records"] == 0
    assert out["sam"][1]["normal_reads"]["regions_records"] == regions
    assert out["bam"][1]["normal_reads"]["reads_kept"] == out["sam"][1]["normal_reads"]["reads_kept"] > 0
