"""The k-mer engine's input domain as a grid of named cases, for holding
the engine to the JAX package on the CPU and the card's kernels to their
plain versions.

Each case is one k of ``KS`` and one variant of ``VARIANTS``: a small
region (a sample of 12 errored reads of 24 bases tiled over a haplotype
that carries 12 novel bases against a reference of 64, a matched normal of
6 reads of 22 over the reference, min_count 2) with one thing changed: no
reads, reads shorter than k, lengths of 0, below 0 or past the row, codes
5-7 or below 0, a reference that is empty, shorter than k or all N, a
normal that is absent, empty, shorter than k, of zero lengths or all N,
or another min_count. ``KS`` runs from k = -2, which the JAX functions
take (a window of no base: code 0), through 16 and 17, which they refuse
but for ``revcomp_kmers`` (a uint32 code that wraps past k = 16). Inputs
are made with numpy from the case's seed.
"""

from __future__ import annotations

import numpy as np

KS = (-2, -1, 0, 1, 2, 11, 15, 16, 17)
VARIANTS = ("base", "no_reads", "reads_shorter_than_k", "lengths_off_the_row", "codes_5_to_7",
            "negative_bytes", "empty_ref", "ref_shorter_than_k", "all_n_ref", "no_normal",
            "empty_normal", "normal_shorter_than_k", "normal_of_zero_lengths", "all_n_normal",
            "min_count_-1", "min_count_0", "min_count_1")
R, L, REF, NORMAL = 12, 24, 64, (6, 22)


def cases():
    """Every case's name, "k=<k>/<variant>"."""
    return [f"k={k}/{v}" for k in KS for v in VARIANTS]


def case(name: str) -> dict:
    """The case's inputs: ``k``, ``sample_codes`` [R, L] int8,
    ``sample_lengths`` [R] int32, ``ref_codes`` int8, ``normal_codes`` and
    ``normal_lengths`` (None: no normal), ``min_count``, and ``codes``:
    uint32 k-mer codes (SENTINEL among them) for the reverse complement, and
    ``contig``: a row of the haplotype for the germline recheck."""
    head, variant = name.split("/")
    k = int(head[2:])
    rng = np.random.default_rng([KS.index(k), VARIANTS.index(variant)])
    ref = rng.integers(0, 4, REF).astype(np.int8)
    hap = np.concatenate([ref[:32], rng.integers(0, 4, 12).astype(np.int8), ref[32:]])

    def tile(n, width, src):
        if n == 0 or width == 0:
            return np.zeros((n, width), np.int8)
        starts = rng.integers(0, len(src) - width + 1, n)
        codes = src[starts[:, None] + np.arange(width)]
        wrong = rng.random(codes.shape) < 0.02
        codes[wrong] = rng.integers(0, 4, int(wrong.sum()))
        return codes.astype(np.int8)

    short = max(k - 1, 0)  # a width shorter than k (k <= 0: a row of no base, which k takes)
    width = short if variant == "reads_shorter_than_k" else L
    rows = 0 if variant == "no_reads" else R
    sample = tile(rows, width, hap)
    lengths = np.full(rows, width, np.int32)
    if variant == "lengths_off_the_row":
        lengths[:] = np.resize([0, -1, -7, k - 1, width, width + 9, 2**31 - 1, -2**31], rows)
    if variant == "codes_5_to_7":
        sample[rng.random(sample.shape) < 0.1] = rng.integers(5, 8)
    if variant == "negative_bytes":
        neg = rng.random(sample.shape) < 0.05
        sample[neg] = rng.integers(-128, 0, int(neg.sum()))
    ref = {"empty_ref": ref[:0], "ref_shorter_than_k": ref[:short],
           "all_n_ref": np.full(REF, 4, np.int8)}.get(variant, ref)
    normal, normal_lengths = None, None
    if variant != "no_normal":
        n_rows = 0 if variant == "empty_normal" else NORMAL[0]
        n_width = short if variant == "normal_shorter_than_k" else NORMAL[1]
        normal = tile(n_rows, n_width, hap[:44])
        normal_lengths = np.full(n_rows, n_width, np.int32)
        if variant == "normal_of_zero_lengths":
            normal_lengths[:] = 0
        if variant == "all_n_normal":
            normal[:] = 4
    min_count = int(variant[len("min_count_"):]) if variant.startswith("min_count") else 2
    top = 1 << (2 * min(max(k, 0), 15))
    codes = np.concatenate([rng.integers(0, top, 40), rng.integers(0, 1 << 32, 10),
                            [0, top - 1, 0xFFFFFFFF, 0xFFFFFFFF]]).astype(np.uint32)
    return dict(k=k, sample_codes=sample, sample_lengths=lengths, ref_codes=ref,
                normal_codes=normal, normal_lengths=normal_lengths, min_count=min_count,
                codes=codes, contig=hap[20:56].copy())


def _outcome(fn):
    try:
        return True, fn()
    except Exception as exc:  # the plain version's refusal is part of its contract
        return False, type(exc)


def held_on_card(name: str, device) -> dict:
    """The case through the card's kernels against their plain versions
    on the card, exact, each launch counted: ``kmer_codes`` (K1) on the
    sample, ``revcomp_kmers`` and ``both_strands`` (K2, both forms) on the
    case's codes, and ``sample_only_kmers`` on the per-function route
    forced (K1-K4), forced to each cluster size the region kernel (K5)
    takes it at, and on the plan's route. Where the plain version refuses,
    the card must refuse too, launching nothing (K2 refuses k > 15, which
    the plain version takes). Returns the launches it made, by kernel, and
    the routes and cluster sizes of its region calls. Raises
    ``AssertionError`` where the card and the plain version differ."""
    import torch

    from breakmer_tpu_torch.ops import kmer, kmer_cuda

    c = case(name)
    k = c["k"]
    made = {"kmer_codes": 0, "revcomp_kmers": 0, "both_strands": 0, "region_kmers": 0,
            "per_function": 0, "clusters": []}

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def same(want, got, what):
        want, got = ((x if isinstance(x, tuple) else (x,)) for x in (want, got))
        for a, b in zip(want, got, strict=True):
            equal = (torch.equal(a, b) if isinstance(a, torch.Tensor)
                     else np.array_equal(a, b))
            assert a.dtype == b.dtype and a.shape == b.shape and equal, (name, what)

    def launched(counter, fn, what, n=1):
        before = dict(kmer_cuda.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        moved = {x: kmer_cuda.LAUNCHES[x] - before[x] for x in before
                 if kmer_cuda.LAUNCHES[x] != before[x]}
        assert moved == ({counter: n} if n else {}), (name, what, moved)
        return out

    def refused(fn, what):
        before = dict(kmer_cuda.LAUNCHES)
        ok, got = _outcome(fn)
        torch.cuda.synchronize()
        assert not ok and kmer_cuda.LAUNCHES == before, (name, what, got)

    codes, lengths = on(c["sample_codes"]), on(c["sample_lengths"])
    ok, want = _outcome(lambda: kmer.kmer_codes_plain(codes, lengths, k))
    if ok:
        n = int(codes.shape[0] > 0)
        same(want, launched("kmer_codes", lambda: kmer.kmer_codes(codes, lengths, k),
                            "kmer_codes", n), "kmer_codes")
        made["kmer_codes"] += n
    else:
        refused(lambda: kmer.kmer_codes(codes, lengths, k), "kmer_codes")
    x = on(c["codes"].astype(np.int64))
    for fn, plain, counter in ((kmer.revcomp_kmers, kmer.revcomp_kmers_plain, "revcomp_kmers"),
                               (kmer.both_strands, kmer.both_strands_plain, "both_strands")):
        if k > kmer_cuda.MAX_K:
            refused(lambda: fn(x, k), counter)
            continue
        same(plain(x, k), launched("revcomp_kmers", lambda: fn(x, k), counter), counter)
        made[counter] += 1

    args = (c["sample_codes"], c["sample_lengths"], c["ref_codes"], k)
    kw = dict(normal_codes=c["normal_codes"], normal_lengths=c["normal_lengths"],
              min_count=c["min_count"])
    ok, want = _outcome(lambda: kmer.sample_only_kmers_plain(*args, **kw, device=device))
    if not ok:
        refused(lambda: kmer.sample_only_kmers(*args, **kw, device=device), "sample_only_kmers")
        return made
    routes = dict(kmer.ROUTES)
    same(want, kmer.sample_only_kmers(*args, **kw, device=device, route="per_function"),
         "per_function")
    made["per_function"] += 1
    normal_shape = None if c["normal_codes"] is None else c["normal_codes"].shape
    for C in kmer_cuda.cluster_sizes(device):
        if kmer_cuda.card_plan(args[0].shape, len(args[2]), normal_shape, k, device,
                               C).route != "fused":
            continue
        v, n = launched("region_kmers",
                        lambda: kmer_cuda.region_kmers(*args, **kw, device=device, cluster=C),
                        f"region_kmers at {C}")
        same(want, kmer._by_count(v, n, c["min_count"]), f"region_kmers at {C}")
        made["region_kmers"] += 1
        made["clusters"].append(C)
    plan = kmer_cuda.card_plan(args[0].shape, len(args[2]), normal_shape, k, device)
    same(want, kmer.sample_only_kmers(*args, **kw, device=device), f"the plan's {plan.route}")
    made["region_kmers"] += plan.route == "fused"
    made["per_function"] += plan.route == "per_function"
    assert kmer.ROUTES == dict(routes, per_function=routes["per_function"] + 1 + (
        plan.route == "per_function"), fused=routes["fused"] + (plan.route == "fused")), name
    return made
