"""Realignment: seed index + batched SW + host traceback.

Replaces the reference's BLAT suite (SURVEY.md §2 #11-12): ``blat`` vs the
region reference becomes SeedIndex.candidates + ops.sw batched scoring;
``gfServer``/``gfClient`` (whole-genome 2bit server) becomes a GenomeIndex
held in memory — no sockets, no subprocesses, no PSL text.
"""

from breakmer_tpu_torch.align.index import SeedIndex, GenomeIndex
from breakmer_tpu_torch.align.realign import AlignSegment, realign_contig
from breakmer_tpu_torch.align.traceback import traceback_align, Alignment

__all__ = [
    "SeedIndex", "GenomeIndex", "AlignSegment", "realign_contig",
    "traceback_align", "Alignment",
]
