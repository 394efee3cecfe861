"""The k-mer engine over its input domain on the CPU: on every case of
``breakmer_tpu_torch.testing.kmer_domain`` (k from -2 to 17 crossed with
the edges of each input), the port's ``kmer_codes``, ``revcomp_kmers``,
``kmer_table``, ``novel_kmer_normal_support`` and ``sample_only_kmers``
give the JAX package's value, or raise the JAX package's exception type;
and the card's admission of a region (``kmer_cuda.check_region``, then
``kmer_cuda.card_plan`` with an H100's limits and no card) takes exactly
the cases the JAX package answers. Exact (tolerance 0: integer outputs).
The same grid runs through the kernels on a card in
``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from breakmer_tpu.ops import kmer as jk
from breakmer_tpu_torch.ops import kmer as tk
from breakmer_tpu_torch.ops import kmer_cuda
from breakmer_tpu_torch.testing import kmer_domain

SENT = 0xFFFFFFFF


def _outcome(fn):
    """(True, the value as numpy arrays) or (False, the exception's type)."""
    try:
        out = fn()
    except Exception as exc:  # the JAX package's failure is part of its contract
        return False, type(exc)
    out = out if isinstance(out, tuple) else (out,)
    return True, tuple(np.asarray(o.cpu() if isinstance(o, torch.Tensor) else o) for o in out)


def _same(want, got, what):
    assert want[0] == got[0], (what, want, got)
    if not want[0]:
        assert want[1] is got[1], (what, want[1], got[1])
        return
    for a, b in zip(want[1], got[1], strict=True):
        assert a.shape == b.shape and np.array_equal(a, b), (what, a, b)


def _table(fn):
    try:
        return fn()
    except Exception:  # a set the JAX package refuses gives the recheck no table
        return np.zeros(0, np.uint32)


@pytest.mark.parametrize("name", kmer_domain.cases())
def test_kmer_engine_matches_jax_over_its_domain(name, monkeypatch):
    c = kmer_domain.case(name)
    k, codes, lengths = c["k"], c["sample_codes"], c["sample_lengths"]
    normal = dict(normal_codes=c["normal_codes"], normal_lengths=c["normal_lengths"])

    def as_u32(t):
        return tuple(np.asarray(x).astype(np.uint32) if x.dtype != np.bool_ else x for x in t)

    jax_codes = _outcome(lambda: jk.kmer_codes(jnp.asarray(codes), jnp.asarray(lengths), k))
    port_codes = _outcome(lambda: tk.kmer_codes(torch.from_numpy(codes),
                                                torch.from_numpy(lengths), k))
    _same(*((ok, as_u32(v) if ok else v) for ok, v in (jax_codes, port_codes)), what="codes")
    if jax_codes[0] and k <= 0:  # a window of no base: code 0 wherever it lies in its read
        km, valid = jax_codes[1]
        assert (km[valid] == 0).all() and (km[~valid] == SENT).all()

    x = c["codes"]
    _same(_outcome(lambda: jk.revcomp_kmers(jnp.asarray(x), k)),
          _outcome(lambda: tk.revcomp_kmers(torch.from_numpy(x.astype(np.int64)), k)),
          "revcomp_kmers")
    _same(_outcome(lambda: jk.kmer_table(codes, lengths, k)),
          _outcome(lambda: tk.kmer_table(codes, lengths, k, device="cpu")), "kmer_table")

    ref = c["ref_codes"]
    ref_table = _table(lambda: jk.kmer_table(ref.reshape(1, -1), np.array([len(ref)], np.int32),
                                             k))
    normal_table = (np.zeros(0, np.uint32) if c["normal_codes"] is None else
                    _table(lambda: jk.kmer_table(c["normal_codes"], c["normal_lengths"], k,
                                                 add_rc=False)))
    _same(_outcome(lambda: jk.novel_kmer_normal_support(c["contig"], ref_table, normal_table,
                                                        k)),
          _outcome(lambda: tk.novel_kmer_normal_support(c["contig"], ref_table, normal_table,
                                                        k, device="cpu")),
          "novel_kmer_normal_support")

    args = (codes, lengths, ref, k)
    kw = dict(normal, min_count=c["min_count"])
    want = _outcome(lambda: jk.sample_only_kmers(*args, **kw))
    _same(want, _outcome(lambda: tk.sample_only_kmers(*args, **kw, device="cpu")),
          "sample_only_kmers")
    if want[0] and k <= 0:  # the reference's code 0 removes the sample's one value
        assert all(len(a) == 0 for a in want[1])

    # the card's admission, before anything would touch it
    monkeypatch.setattr(kmer_cuda, "smem_optin", lambda device: kmer_cuda.H100_SMEM_OPTIN)
    monkeypatch.setattr(kmer_cuda, "cluster_sizes", lambda device: kmer_cuda.H100_CLUSTERS)

    try:
        kmer_cuda.check_region(codes, lengths, len(ref), c["normal_codes"],
                               c["normal_lengths"], k)
        plan = kmer_cuda.card_plan(codes.shape, len(ref), None if c["normal_codes"] is None
                                   else c["normal_codes"].shape, k, "cuda")
    except ValueError:
        plan = None
    assert (plan is not None) == want[0], (name, plan)
    if plan is not None:
        assert plan.route == "fused" and plan.windows == codes.shape[0] * (codes.shape[1] - k + 1)


@pytest.mark.parametrize("batched", [False, True], ids=["serial", "batched"])
def test_cli_run_at_k_0_matches_jax(batched, tmp_path):
    """``cli run`` on scenario seed 1 (two genes, a matched normal) at
    kmer_size = seed_kmer_size = 0, which the config takes: the port's
    svs.out, VCF and ledger rows equal the JAX package's byte for byte,
    and neither run records a region error."""
    import json

    from breakmer_tpu.cli import main as jax_main
    from breakmer_tpu_torch.cli import main as port_main
    from tests.scenarios import build_scenario

    cfg_kwargs, _ = build_scenario(1, tmp_path, n_genes=2, kinds=["ins", "del"],
                                   with_normal_germline=True)
    cfg_kwargs.pop("reference_data_dir")  # each run builds its own index
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({**cfg_kwargs, "kmer_size": 0, "seed_kmer_size": 0,
                                    "batch_regions": batched, "device": "cpu",
                                    "log_level": "WARNING"}))
    out = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        adir = tmp_path / name
        assert main(["run", str(cfg_file), "--analysis-dir", str(adir)]) == 0
        ledger = json.loads((adir / "ledger.json").read_text())
        metrics = json.loads((adir / "metrics.json").read_text())
        assert metrics["errors"] == {} and metrics["targets"] == len(ledger) == 3, name
        out[name] = ((adir / "output" / "prop_svs.out").read_bytes(),
                     (adir / "output" / "prop.vcf").read_bytes(),
                     {n: (e["rows"], e["vcf"], e["error"]) for n, e in ledger.items()})
    assert out["port"] == out["jax"]
