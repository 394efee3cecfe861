"""The port's genome seed index as a directory of mapped arrays.

``GenomeIndex.save`` writes one ``.npy`` an array and ``GenomeIndex.load``
maps them read-only. The mapped index must answer every query exactly as
the index built in memory and as the v2 ``.npz`` of the same genome that
the JAX package writes (the format of earlier caches). The runner maps a
saved index, converts a v2 cache once, and never takes a directory that a
save left unfinished; its output does not depend on where the index came
from."""

import json
import threading

import numpy as np
import pytest

from breakmer_tpu.align.index import GenomeIndex as JaxGenomeIndex
from breakmer_tpu_torch.align import index as index_mod
from breakmer_tpu_torch.align.index import GenomeIndex, is_saved
from breakmer_tpu_torch.config import Config
from breakmer_tpu_torch.encode import revcomp_codes
from breakmer_tpu_torch.runner import Runner
from breakmer_tpu_torch.testing.scenarios import build_scenario

# (k, step, chromosome lengths, dense bucket table)
GENOMES = {
    "k11_step1_sparse": (11, 1, (20_000, 13_000, 7_000), False),
    "k11_stepk_sparse": (11, 11, (20_000, 13_000, 7_000), False),
    "k5_step1_dense": (5, 1, (9_000, 6_000, 3_000), True),
    "k5_stepk_dense": (5, 5, (9_000, 6_000, 3_000), True),
    "k11_step1_40_contigs": (11, 1, (1_500,) * 40, False),
}


def make_genome(lengths, seed=5):
    """Chromosomes of random bases with N runs at both ends and inside."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, n in enumerate(lengths):
        codes = rng.integers(0, 4, n, dtype=np.int8)
        codes[: 30 + 7 * i] = 4
        codes[n - 50 - 3 * i:] = 4
        for s in rng.integers(200, n - 400, 3):
            codes[s:s + int(rng.integers(1, 90))] = 4
        out[f"chr{i + 1}"] = codes
    return out


def queries(genome, seed=9):
    """Pieces of the genome, mutated, reverse-complemented, across two
    chromosomes, over N runs, and random bases."""
    rng = np.random.default_rng(seed)
    names = list(genome)
    out = []
    for _ in range(12):
        c = genome[names[int(rng.integers(0, len(names)))]]
        s = int(rng.integers(0, len(c) - 300))
        q = c[s:s + int(rng.integers(40, 300))].copy()
        hit = rng.random(len(q)) < 0.03
        q[hit] = rng.integers(0, 4, int(hit.sum()), dtype=np.int8)
        out.append(q)
        out.append(revcomp_codes(q))
    a, b = genome[names[0]], genome[names[-1]]
    out.append(np.concatenate([a[500:650], b[900:1050]]))
    out.append(a[:200].copy())  # the leading N run and what follows it
    out.append(rng.integers(0, 4, 150, dtype=np.int8))
    return out


def fetch_windows(genome):
    for name, codes in genome.items():
        n = len(codes)
        yield from ((name, 0, 80), (name, n - 120, n + 40), (name, 190, 1_210),
                    (name, -5, 3), (name, 500, 500), (name, n // 2, n // 2 + 17))


def answers(gi, genome):
    """Everything the index's callers read of it."""
    qs = queries(genome)
    codes = np.unique(np.concatenate([index_mod._seed_codes(q, gi.k)[0] for q in qs[:6]]))[:40]
    return {
        "chroms": gi.chroms,
        "length": {c: gi.length(c) for c in gi.chroms},
        "nbytes": gi.nbytes,
        "candidates": [gi.candidates(q, max_windows=20) for q in qs],
        "lookup_chrom": {c: [gi.lookup_chrom(c, int(x)).tolist() for x in codes] for c in gi.chroms},
        "fetch_codes": [gi.fetch_codes(*w).tolist() for w in fetch_windows(genome)],
        "per_chrom_seed_arrays": {c: (a.tolist(), b.tolist())
                                  for c, (a, b) in gi.per_chrom_seed_arrays().items()},
    }


@pytest.fixture(scope="module", params=list(GENOMES), ids=list(GENOMES))
def indexed(request, tmp_path_factory):
    """(genome, built index, its saved directory, its v2 .npz written by
    the JAX package, dense)."""
    k, step, lengths, dense = GENOMES[request.param]
    genome = make_genome(lengths)
    work = tmp_path_factory.mktemp(request.param)
    built = GenomeIndex(genome, k=k, step=step)
    built.save(work / "index")
    JaxGenomeIndex(genome, k=k, step=step).save(str(work / "index_v2.npz"))
    return genome, built, work / "index", work / "index_v2.npz", dense


def test_mapped_index_answers_as_the_built_and_the_v2_index(indexed):
    genome, built, saved, v2, _ = indexed
    want = answers(built, genome)
    assert any(want["candidates"]) and any(any(v) for v in want["lookup_chrom"].values())
    assert answers(GenomeIndex.load(saved), genome) == want
    assert answers(GenomeIndex.load(v2), genome) == want


def test_saved_arrays_come_back_as_read_only_maps(indexed):
    _, built, saved, _, dense = indexed
    gi = GenomeIndex.load(saved)
    mapped = [gi._positions]
    for pc in gi._packed.values():
        mapped += [pc.packed, pc.n_starts, pc.n_ends]
    if dense:
        mapped.append(gi._offsets)
    for a in mapped:
        assert isinstance(a, np.memmap) and not a.flags.writeable
        assert str(a.filename).startswith(str(saved))
    # the sparse table's offsets are rebuilt; the dense one is the file's
    assert isinstance(gi._offsets, np.memmap) == dense
    assert np.array_equal(gi._offsets, built._offsets)
    assert gi._offsets.dtype == np.int64 and len(gi._offsets) == 4 ** gi.k + 1
    assert [p.name for p in saved.parent.iterdir() if ".partial" in p.name] == []
    # one file an array, whatever the count of contigs
    table = ["offsets.npy"] if dense else ["bucket_nz.npy", "bucket_nz_counts.npy"]
    assert sorted(p.name for p in saved.iterdir()) == sorted(
        table + ["meta.json", "nends.npy", "nstarts.npy", "packed.npy", "positions.npy"])


def test_load_refuses_another_format(tmp_path):
    gi = GenomeIndex(make_genome((3_000,)), k=5)
    gi.save(tmp_path / "index")
    meta = json.loads((tmp_path / "index" / "meta.json").read_text())
    (tmp_path / "index" / "meta.json").write_text(json.dumps({**meta, "format": 4}))
    with pytest.raises(ValueError, match="format 4"):
        GenomeIndex.load(tmp_path / "index")


def test_a_cut_save_leaves_nothing_a_reader_takes(tmp_path, monkeypatch):
    gi = GenomeIndex(make_genome((3_000, 2_000)), k=5)
    real_save, written = np.save, []

    def cut(path, a):
        if len(written) == 3:
            raise OSError("cut")
        written.append(path)
        real_save(path, a)

    monkeypatch.setattr(np, "save", cut)
    with pytest.raises(OSError, match="cut"):
        gi.save(tmp_path / "index")
    assert list(tmp_path.iterdir()) == [] and not is_saved(tmp_path / "index")


def test_concurrent_saves_of_one_index_leave_one_whole_index(tmp_path):
    genome = make_genome((6_000, 4_000))
    gi = GenomeIndex(genome, k=5)
    errors = []

    def save():
        try:
            gi.save(tmp_path / "index")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=save) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert [p.name for p in tmp_path.iterdir()] == ["index"]
    assert answers(GenomeIndex.load(tmp_path / "index"), genome) == answers(gi, genome)


# -- the runner ---------------------------------------------------------------
@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    work = tmp_path_factory.mktemp("scenario")
    cfg_kwargs, _ = build_scenario(1, work, n_genes=3, kinds=["ins", "del", "inv"])
    cfg_kwargs.update(batch_regions=False, device="cpu", log_level="WARNING")
    return cfg_kwargs


def run_sample(cfg_kwargs, out, refdata):
    Runner(Config(**{**cfg_kwargs, "analysis_dir": str(out),
                     "reference_data_dir": None if refdata is None else str(refdata)})).run()
    ledger = json.loads((out / "ledger.json").read_text())
    metrics = json.loads((out / "metrics.json").read_text())
    return {
        "svs": (out / "output" / "prop_svs.out").read_bytes(),
        "vcf": (out / "output" / "prop.vcf").read_bytes(),
        "ledger": {n: {k: v for k, v in e.items() if k != "elapsed_s"} for n, e in ledger.items()},
    }, metrics["index"]


@pytest.fixture(scope="module")
def in_memory_run(scenario, tmp_path_factory):
    got, index = run_sample(scenario, tmp_path_factory.mktemp("in_memory"), None)
    assert index["source"] == "built" and got["svs"].count(b"\n") > 1
    return got, index


@pytest.mark.parametrize("cache", ["none", "v2"])
def test_two_runners_on_one_reference_dir_match_an_in_memory_run(scenario, in_memory_run, tmp_path, cache):
    want, want_index = in_memory_run
    refdata = tmp_path / "refdata"
    refdata.mkdir()
    v2 = refdata / "genome_genome_index_v2_k11.npz"
    if cache == "v2":  # a cache that an earlier version wrote
        from breakmer_tpu.io.fasta import FastaIndex

        fa = FastaIndex(scenario["reference_fasta"])
        JaxGenomeIndex(((n, fa.fetch_codes(n, 0, fa.length(n))) for n in fa.names), 11).save(str(v2))
        v2_bytes = v2.read_bytes()
    first, first_index = run_sample(scenario, tmp_path / "first", refdata)
    second, second_index = run_sample(scenario, tmp_path / "second", refdata)
    assert first == want and second == want
    assert first_index == {"source": "built" if cache == "none" else "converted", "bytes": want_index["bytes"]}
    assert second_index == {"source": "mapped", "bytes": want_index["bytes"]}
    assert is_saved(refdata / "genome_genome_index_v3_k11")
    assert (cache == "v2") == v2.exists() and (cache == "none" or v2.read_bytes() == v2_bytes)


def test_the_runner_never_takes_a_partial_directory(scenario, in_memory_run, tmp_path):
    """A whole index left under a ``.partial`` name (a save cut before its
    move) is not the cache: the runner builds and saves its own."""
    want, _ = in_memory_run
    refdata = tmp_path / "refdata"
    run_sample(scenario, tmp_path / "first", refdata)
    final = refdata / "genome_genome_index_v3_k11"
    partial = refdata / "genome_genome_index_v3_k11.partial-cut"
    final.rename(partial)
    got, index = run_sample(scenario, tmp_path / "second", refdata)
    assert got == want and index["source"] == "built"
    assert is_saved(final) and is_saved(partial)
