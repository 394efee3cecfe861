"""Contig assembly: greedy k-mer-extension (reference: sv_assembly.py) and
overlap-layout-consensus helpers (reference: olc.py)."""

from breakmer_tpu_torch.assemble.greedy import Contig, ContigRead, assemble
from breakmer_tpu_torch.assemble.olc import merge_contigs, overlap

__all__ = ["Contig", "ContigRead", "assemble", "merge_contigs", "overlap"]
