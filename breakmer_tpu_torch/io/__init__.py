"""File-format readers (first party — the environment has no pysam/htslib).

Replaces the reference's L0/L1 tool surface (SURVEY.md §1): samtools faidx /
pysam fetch -> fasta.py + sam.py/bam.py; fastq round-trips -> fastq.py;
targets BED parsing (reference: sv_processor.py runner BED parser) -> bed.py.
"""

from breakmer_tpu_torch.io.fasta import read_fasta, write_fasta, FastaIndex
from breakmer_tpu_torch.io.fastq import read_fastq, write_fastq
from breakmer_tpu_torch.io.bed import read_targets_bed, TargetRegion
from breakmer_tpu_torch.io.sam import read_sam, SamRecord

__all__ = [
    "read_fasta", "write_fasta", "FastaIndex",
    "read_fastq", "write_fastq",
    "read_targets_bed", "TargetRegion",
    "read_sam", "SamRecord",
]
