"""The repository's entry points: the single-device step and the
multi-device dry run, on the card unless the caller names the CPU.

Port of the JAX entry file ``__graft_entry__.py``, with its three names:

``entry(device)`` returns ``(fn, example_args)``: the fused region step
(``parallel/step.make_region_step(mesh=None, k=15)``, one launch of each
kernel a call on the card, two of ``kmer_codes``) and ``_example_inputs()``
as tensors on ``device``.

``dryrun_multichip(n, devices)`` runs the JAX file's three stages on a
mesh of n devices: the sharded region step, the sharded seed table
against ``GenomeIndex``, and the batched ``Runner`` over the mesh on a
four-target planted-SV panel, call-identical to the serial ``Runner``.
``devices`` defaults to the first n visible cards and raises with fewer
(the JAX package's mesh takes what it is given); a virtual mesh is
asked for explicitly: ``[cuda:0] * 4`` on one card, ``[cpu] * 4`` on the
CPU. The JAX file's ``assert``s become checks that raise
``AssertionError`` under ``python -O`` too.
"""

from __future__ import annotations

import json
import shutil
import tempfile
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from breakmer_tpu_torch.device import resolve, virtual_devices
from breakmer_tpu_torch.parallel.mesh import make_mesh_2d, mesh_devices
from breakmer_tpu_torch.parallel.step import make_region_step


def _example_inputs(G=4, R=64, L=128, Lref=2048, B=16, Lq=256, Lt=512, seed=0):
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, size=(G, R, L)).astype(np.int8)
    lengths = np.full((G, R), L, dtype=np.int32)
    refs = rng.integers(0, 4, size=(G, Lref)).astype(np.int8)
    ref_lengths = np.full((G,), Lref, dtype=np.int32)
    q = rng.integers(0, 4, size=(G, B, Lq)).astype(np.int8)
    t = rng.integers(0, 4, size=(G, B, Lt)).astype(np.int8)
    return reads, lengths, refs, ref_lengths, q, t


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def entry(device="cuda") -> Tuple[Callable, Tuple[torch.Tensor, ...]]:
    """(fn, example_args): the single-device region step and its example
    inputs on ``device`` ("cuda" and "auto" mean the card and raise
    without one; "cpu" runs the plain versions)."""
    dev = resolve(device)
    fn = make_region_step(mesh=None, k=15)
    return fn, tuple(torch.from_numpy(a).to(dev) for a in _example_inputs())


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> None:
    """The three stages on a mesh of the first ``n_devices`` of ``devices``
    (default: the visible cards):

    1. the sharded region step on an n-device (regions x pairs) mesh;
    2. the sharded genome seed table against the replicated index;
    3. the batched Runner over the n devices on a miniature planted-SV
       panel, call-identical to the serial Runner.
    """
    devs = mesh_devices(n_devices, devices)
    _dryrun_step(devs)
    _dryrun_index(devs)
    _dryrun_full_panel(devs)


def _dryrun_step(devs: List[torch.device]) -> None:
    mesh = make_mesh_2d(devices=devs)
    step = make_region_step(mesh=mesh, k=9)
    G = max(8, len(devs))          # divisible by the regions axis
    B = max(8, len(devs))          # divisible by the pairs axis
    inputs = _example_inputs(G=G, R=8, L=32, Lref=128, B=B, Lq=16, Lt=32)
    values, counts, scores, q_end, t_end = step(
        *(torch.from_numpy(a).to(mesh.first) for a in inputs))
    if mesh.first.type == "cuda":  # a kernel fault surfaces in this stage
        torch.cuda.synchronize(mesh.first)
    _require(tuple(scores.shape) == (G, B), f"scores shape {tuple(scores.shape)}")


def _dryrun_index(devs: List[torch.device]) -> None:
    from breakmer_tpu_torch.align.index import GenomeIndex
    from breakmer_tpu_torch.encode import decode_seq, encode_seq
    from breakmer_tpu_torch.parallel.index_shard import ShardedGenomeIndex, make_shard_mesh

    rng = np.random.default_rng(1)
    genome = {
        c: decode_seq(rng.integers(0, 4, 4096).astype(np.int8))
        for c in ("chr1", "chr2")
    }
    gi = GenomeIndex(genome, k=11)
    si = ShardedGenomeIndex(gi, make_shard_mesh(devices=devs))
    contig = encode_seq(genome["chr1"][1000:1200])
    wins = si.candidates(contig)
    ref = gi.candidates(contig)
    _require([(w.chrom, w.t_start, w.t_end) for w in wins]
             == [(w.chrom, w.t_start, w.t_end) for w in ref],
             "sharded index disagrees with replicated index")


def _write_panel(work: Path) -> dict:
    """The JAX dry run's panel (an insertion, a deletion, a translocation
    and a reference region) under ``work``; the Config keyword arguments."""
    from breakmer_tpu_torch.io.fasta import write_fasta
    from breakmer_tpu_torch.testing.fixtures import (
        ErrorModel, Haplotype, NovelBlock, RefBlock, SamBuilder, rand_seq,
    )

    genome = {"chr1": rand_seq(31, 9000), "chr2": rand_seq(32, 6000)}
    write_fasta(work / "genome.fa", genome)
    with open(work / "targets.bed", "w") as fh:
        fh.write("chr1\t1000\t1600\tDRY_INS\n")
        fh.write("chr1\t3000\t3800\tDRY_DEL\n")
        fh.write("chr1\t5000\t5600\tDRY_TRL\n")
        fh.write("chr1\t7000\t7500\tDRY_REF\n")
    sam = SamBuilder(genome, error_model=ErrorModel(), error_seed=17)
    INS = "TTGACCATGGATCCGGTACAT"
    sam.add_haplotype_reads(Haplotype(genome, [
        RefBlock("chr1", 1000, 1300), NovelBlock(INS),
        RefBlock("chr1", 1300, 1600),
    ]), 180, 440, prefix="di")
    sam.add_haplotype_reads(Haplotype(genome, [
        RefBlock("chr1", 3000, 3400), RefBlock("chr1", 3460, 3800),
    ]), 180, 620, prefix="dd")
    sam.add_haplotype_reads(Haplotype(genome, [
        RefBlock("chr1", 5000, 5300), RefBlock("chr2", 3000, 3400),
    ]), 180, 420, prefix="dt")
    sam.add_discordant_pairs("chr1", 5300, "chr2", 3000, n=5)
    for s, e in ((1000, 1600), (3000, 3800), (5000, 5600), (7000, 7500)):
        sam.add_background_pairs("chr1", s - 200, e + 200, prefix=f"bg{s}")
    sam.write(work / "sample.sam")
    return dict(
        analysis_name="dryrun",
        targets_bed_file=str(work / "targets.bed"),
        reference_fasta=str(work / "genome.fa"),
        reference_data_dir=str(work / "refdata"),
        sample_bam_file=str(work / "sample.sam"),
        kmer_size=15, indel_size=15,
        indel_sr_thresh=2, rearr_sr_thresh=2, trl_sr_thresh=2,
    )


def _run(base: dict, out: Path, device: str, batch_regions: bool):
    """One Runner's event rows and the runner; fails on any region error
    (a CUDA fault is sticky: a panel of errors must not match another)."""
    from breakmer_tpu_torch.config import Config
    from breakmer_tpu_torch.report import event_row
    from breakmer_tpu_torch.runner import Runner

    runner = Runner(Config(analysis_dir=str(out), batch_regions=batch_regions,
                           device=device, **base))
    runner.setup()
    rows = [event_row(e) for e in runner.run()]
    errors = json.loads((out / "metrics.json").read_text())["errors"]
    _require(not errors, f"{out.name} run: region errors {errors}")
    return rows, runner


def _dryrun_full_panel(devs: List[torch.device]) -> None:
    """The batched Runner with the runner's local devices set to ``devs``
    (its k-mer launches shard over them as on a multi-card host), checked
    call-identical to the serial Runner on ``devs[0]``."""
    device = str(devs[0])
    work = Path(tempfile.mkdtemp(prefix="breakmer_dryrun_"))
    try:
        base = _write_panel(work)
        want, _ = _run(base, work / "serial", device, batch_regions=False)
        with virtual_devices(devs):
            got, batched = _run(base, work / "batched", device, batch_regions=True)
        mesh = batched.kmer_pipeline.mesh
        _require((1 if mesh is None else mesh.devices.size) == len(devs),
                 f"the batched runner's k-mer pipeline ran on {mesh}, "
                 f"not on {len(devs)} devices")
        _require(got == want, "mesh-batched runner calls diverge from serial:"
                              f"\n{got}\nvs\n{want}")
        genes = {r[0] for r in got}  # event_row: column 0 is genes
        _require({"DRY_INS", "DRY_DEL", "DRY_TRL"} <= genes, f"genes called: {genes}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
