"""The tumour BAM's ingest (``breakmer_tpu_torch/io/bam_ingest.py``) against
the eager whole-file decode (``native.bam_decode_columns``): every
fixed-width column, and the codes, qualities and names of gathered rows,
on the scenario BAMs of seeds 1, 7 and 91 at 1 and 4 threads and on files
made for their edges (records across BGZF blocks, ``*`` sequences, 0xFF
qualities, the longest names, no records). A file the ingest refuses, or a
host without the library, is read as records."""

import contextlib
import gzip
import struct
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from breakmer_tpu_torch import native, reads
from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.extract import (
    extract_all_reads,
    extract_all_reads_columnar,
    extract_sv_reads,
    extract_sv_reads_columnar,
    global_discordant_pairs,
    global_discordant_pairs_columnar,
)
from breakmer_tpu_torch.io import bam_ingest
from breakmer_tpu_torch.io.bam import BGZF_BLOCK_U, BamReader, read_alignments, write_bam
from breakmer_tpu_torch.io.bam_columns import column_qnames
from breakmer_tpu_torch.io.sam import SamRecord, parse_cigar, parse_sam_line
from breakmer_tpu_torch.testing.scenarios import build_scenario
from breakmer_tpu_torch.utils.meter import METER

pytestmark = pytest.mark.skipif(not (native.available() and bam_ingest.available()),
                                reason="the native library or the BAM ingest library is not built")

REFS = [("chr1", 100_000), ("chr2", 5_000)]


def _eager(path):
    reader = BamReader(path)
    return native.bam_decode_columns(reader._data, reader._align_off), [n for n, _ in reader.refs]


def _assert_equal_to_eager(path, rng):
    """The ingest's columns and every gather equal the eager decode's."""
    cols, ref_names, fields = bam_ingest.ingest_bam(str(path))
    want, want_refs = _eager(path)
    assert ref_names == want_refs and cols["n"] == want["n"]
    n = cols["n"]
    if not n:
        return cols, fields
    assert cols["max_seq"] == want["max_seq"]
    for name in bam_ingest.FIXED_COLUMNS:
        assert np.array_equal(cols[name], want[name]), name
    every = np.arange(n)
    got = fields.gather(every, cols["max_seq"], codes=True, quals=True, names=True)
    assert np.array_equal(got.codes, want["seq_codes"])
    assert np.array_equal(got.quals, want["quals"])
    assert got.names == column_qnames(want["names"])
    # a region's rows, in file order and not, at their own longest read
    for rows in (np.sort(rng.choice(n, min(n, 37), replace=False)), rng.permutation(n)[:11]):
        width = int(want["lseq"][rows].max())
        part = fields.gather(rows, width, codes=True, quals=True, names=True)
        assert np.array_equal(part.codes, want["seq_codes"][rows, :width])
        assert np.array_equal(part.quals, want["quals"][rows, :width])
        assert part.names == column_qnames(want["names"][rows])
        only = fields.gather(rows, width, quals=True)
        assert only.codes is None and only.names is None and np.array_equal(only.quals, part.quals)
    return cols, fields


@pytest.fixture(scope="module")
def scenario_bams(tmp_path_factory):
    """The scenario samples of seeds 1, 7 and 91 as BAMs of the same records."""
    out = {}
    for seed in (1, 7, 91):
        work = tmp_path_factory.mktemp(f"ingest{seed}")
        cfg_kwargs, _ = build_scenario(seed, work, n_genes=4, kinds=["inv", "trl", None, None],
                                       with_normal_germline=True, multi_sv_gene=True)
        lines = Path(cfg_kwargs["sample_bam_file"]).read_text().splitlines()
        refs = [(x.split("SN:")[1].split("\t")[0], int(x.split("LN:")[1]))
                for x in lines if x.startswith("@SQ")]
        recs = [parse_sam_line(x) for x in lines if x and not x.startswith("@")]
        out[seed] = work / "sample.bam"
        write_bam(out[seed], refs, recs)
        (work / "sample.sam").write_text(Path(cfg_kwargs["sample_bam_file"]).read_text())
    return out


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("seed", [1, 7, 91])
def test_scenario_bam_equals_the_eager_decode(scenario_bams, seed, threads, monkeypatch):
    monkeypatch.setenv("BREAKMER_NATIVE_THREADS", threads)
    cols, _ = _assert_equal_to_eager(scenario_bams[seed], np.random.default_rng(seed))
    assert cols["n"] > 500


@pytest.mark.parametrize("source", ["bam", "sam"])
@pytest.mark.parametrize("seed", [1, 7, 91])
def test_extraction_over_the_columns_equals_the_record_path(scenario_bams, seed, source):
    """Each region's SV reads (codes, qualities, names, lengths), coverage
    and discordant pairs, the extension pool and the run-level discordant
    map: over the BAM's ingest and over the SAM text's decode, as the
    record path gives them."""
    path = scenario_bams[seed] if source == "bam" else scenario_bams[seed].with_suffix(".sam")
    if source == "bam":
        cols, ref_names, fields = bam_ingest.ingest_bam(str(path))
        assert isinstance(fields, bam_ingest.BamFields)
    else:
        cols, ref_names = native.sam_decode_columns(path.read_bytes())
        fields = bam_ingest.DecodedFields(cols)
    records = list(read_alignments(path))
    lengths = dict(BamReader(scenario_bams[seed]).refs)
    regions = [(chrom, start, start + 4_000) for chrom in ref_names
               for start in range(0, lengths[chrom], 2_500)]
    kept = 0
    for cfg in (Config(), Config(clip_coverage=True)):
        for region in regions:
            want = extract_sv_reads(read_alignments(path, region=region), region, cfg)
            got = extract_sv_reads_columnar(cols, fields, ref_names, region, cfg)
            assert (got.n_records, got.n_sv_reads) == (want.n_records, want.n_sv_reads), region
            assert got.batch.names == want.batch.names
            assert np.array_equal(got.batch.lengths, want.batch.lengths)
            assert np.array_equal(got.batch.codes, want.batch.codes)
            assert np.array_equal(got.batch.quals, want.batch.quals)
            assert got.disc.pairs == want.disc.pairs
            assert np.array_equal(got.coverage, want.coverage)
            kept += got.n_sv_reads
            pool = extract_all_reads_columnar(cols, fields, ref_names, region)
            want_pool = extract_all_reads(read_alignments(path, region=region), region)
            assert np.array_equal(pool.lengths, want_pool.lengths)
            assert np.array_equal(pool.codes, want_pool.codes)
        pairs = global_discordant_pairs_columnar(cols, fields, ref_names, cfg).pairs
        assert pairs == global_discordant_pairs(records, cfg).pairs and pairs
    assert kept > 100


def _record(i, rng, *, seq=None, qual=None, qname=None, cigar=None):
    length = 60 + i % 41
    seq = "".join(rng.choice(list("ACGTNRY"), length)) if seq is None else seq
    if qual is None:
        qual = [int(x) for x in rng.integers(0, 94, len(seq))] if seq != "*" else []
    if cigar is None:
        cigar = f"{length}M" if seq == "*" else (
            f"{len(seq) - 20 - i % 7}M{20 + i % 7}S" if i % 3 else f"{i % 9 + 1}S{len(seq) - i % 9 - 1}M")
    return SamRecord(qname or f"r{i}", int(rng.integers(0, 4096)), "chr1", 100 + 7 * i, 60,
                     parse_cigar(cigar), "chr2" if i % 5 == 0 else "chr1",
                     int(rng.integers(0, 4000)), int(rng.integers(-500, 500)), seq, qual)


def _edge_records(case, rng):
    """The records of one edge case, among ordinary ones."""
    n = 3000 if case == "across_blocks" else 60
    recs = [_record(i, rng) for i in range(n)]
    for i in range(0, n, 3):
        if case == "star_sequences":
            recs[i] = _record(i, rng, seq="*")
        elif case == "ff_qualities":
            recs[i] = _record(i, rng, qual=[])
        elif case == "longest_names":
            recs[i] = _record(i, rng, qname=("q" * 250 + f"{i:04d}")[-254:])
    return recs


@pytest.mark.parametrize("case", ["across_blocks", "star_sequences", "ff_qualities", "longest_names"])
def test_edge_case_equals_the_eager_decode(case, tmp_path):
    rng = np.random.default_rng(5)
    path = tmp_path / "edge.bam"
    recs = _edge_records(case, rng)
    write_bam(path, REFS, recs)
    cols, fields = _assert_equal_to_eager(path, rng)
    assert cols["n"] == len(recs)
    lseq = cols["lseq"]
    if case == "across_blocks":  # the writer cuts blocks every BGZF_BLOCK_U inflated bytes
        first = fields.offset - 4  # a record's block_size field
        last = np.append(first[1:], len(fields.data)) - 1
        assert (first // BGZF_BLOCK_U != last // BGZF_BLOCK_U).sum() >= 5
    if case == "star_sequences":
        star = lseq == 0
        assert star.sum() == 20
        got = fields.gather(np.flatnonzero(star), 7, codes=True, quals=True)
        assert (got.codes == 4).all() and (got.quals == -1).all()
    if case == "ff_qualities":
        rows = np.arange(0, len(recs), 3)
        got = fields.gather(rows, cols["max_seq"], quals=True)
        assert all((got.quals[j, :lseq[r]] == 40).all() for j, r in enumerate(rows))
    if case == "longest_names":
        got = fields.gather(np.arange(0, len(recs), 3), names=True)
        assert {len(name) for name in got.names} == {254}


def test_a_file_with_no_records(tmp_path):
    path = tmp_path / "empty.bam"
    write_bam(path, REFS, [])
    cols, ref_names, fields = bam_ingest.ingest_bam(str(path))
    assert cols["n"] == 0 and ref_names == ["chr1", "chr2"]
    assert _eager(path)[0] == {"n": 0}
    got = fields.gather(np.zeros(0, np.int64), 5, codes=True, quals=True, names=True)
    assert got.codes.shape == (0, 5) and got.names == []


def test_threads_share_one_ingest(scenario_bams):
    """Gathers from more threads than cores at once, switching often, give
    what one thread gives, and count each row gathered once."""
    cols, _, fields = bam_ingest.ingest_bam(str(scenario_bams[7]))
    n = cols["n"]
    want = bam_ingest.ingest_bam(str(scenario_bams[7]))[2].gather(
        np.arange(n), cols["max_seq"], codes=True, quals=True, names=True)
    chunks = [np.arange(n)[k::7] for k in range(7)] * 3  # each row asked for three times
    got, errors = [], []

    def gather(rows):
        try:
            got.append((rows, fields.gather(rows, cols["max_seq"], codes=True, quals=True,
                                            names=True)))
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    METER.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=gather, args=(rows,)) for rows in chunks]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors and len(got) == len(chunks)
    for rows, g in got:
        assert np.array_equal(g.codes, want.codes[rows]) and np.array_equal(g.quals, want.quals[rows])
        assert g.names == [want.names[i] for i in rows]
    assert METER.sample_reads["rows_gathered"] == n


def test_a_row_outside_the_records_raises(scenario_bams):
    cols, _, fields = bam_ingest.ingest_bam(str(scenario_bams[1]))
    for rows in ([cols["n"]], [-1]):
        with pytest.raises(IndexError):
            fields.gather(np.array(rows), 10, codes=True)
        with pytest.raises(IndexError):
            fields.gather(np.array(rows), names=True)


def _body(path):
    """The inflated stream of a BAM."""
    return BamReader(path)._data


@pytest.mark.parametrize("damage", ["plain_gzip", "not_a_bam", "short_record", "overrun_record"])
def test_a_file_the_ingest_refuses_is_read_as_records(damage, tmp_path, scenario_bams):
    """Refused: a gzip stream without BGZF framing (a BAM is BGZF by its
    specification), a stream that is not a BAM, a record shorter than its
    fixed part and one whose fields overrun it. ``NativeReads`` then serves
    the file's records, which report what is wrong with the first three."""
    data = _body(scenario_bams[1])
    align_off = BamReader(scenario_bams[1])._align_off
    if damage == "not_a_bam":
        data = b"BAI\x01" + data[4:]
    elif damage == "short_record":  # block_size 20
        data = data[:align_off] + struct.pack("<i", 20) + data[align_off + 4:]
    elif damage == "overrun_record":  # l_seq 10,000
        at = align_off + 4 + 16
        data = data[:at] + struct.pack("<i", 10_000) + data[at + 4:]
    path = tmp_path / "damaged.bam"
    path.write_bytes(gzip.compress(data) if damage == "plain_gzip" else _bgzf(data))
    assert bam_ingest.ingest_bam(str(path)) is None
    sample = reads.NativeReads(Config(sample_bam_file=str(path), device="cpu"))
    if damage == "overrun_record":
        with contextlib.suppress(ValueError):
            sample.prewarm()
    else:
        with pytest.raises(ValueError):
            sample.prewarm()
    assert isinstance(sample.resolved, reads.PreloadedReads)


def _bgzf(data: bytes) -> bytes:
    from breakmer_tpu_torch.io.bam import _bgzf_compress

    return _bgzf_compress(data)


def test_without_the_library_a_bam_is_read_as_records(tmp_path, monkeypatch, scenario_bams):
    """No C++ compiler: ``available()`` is False and ``open_sample_reads``
    picks the records of a preloaded BAM, as without the native library."""
    monkeypatch.setattr(bam_ingest, "_lib", None)
    monkeypatch.setattr(bam_ingest, "_load_attempted", False)
    monkeypatch.setattr(bam_ingest, "library_path", lambda: tmp_path / "lib" / "missing.so")
    monkeypatch.setattr(bam_ingest.shutil, "which", lambda name: None)
    assert not bam_ingest.available() and bam_ingest.ingest_bam("any.bam") is None
    cfg = Config(sample_bam_file=str(scenario_bams[1]), device="cpu")
    assert isinstance(reads.open_sample_reads(cfg), reads.PreloadedReads)
