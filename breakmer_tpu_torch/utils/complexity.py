"""Low-complexity contig detection.

Reference: utils.py calc_contig_complexity (SURVEY.md §2 #14's complexity
filter input). The exact reference formula is unverifiable offline; the
pinned rule here (documented, configurable threshold) is trinucleotide
diversity: distinct 3-mers observed / min(64, number of 3-mer windows).
Homopolymers score ~1/len, dinucleotide repeats ~2/len, random sequence
~1.0 for short contigs — a monotone stand-in for any reasonable complexity
measure.
"""

from __future__ import annotations


def contig_complexity(seq: str, k: int = 3) -> float:
    n = len(seq) - k + 1
    if n <= 0:
        return 0.0
    distinct = len({seq[i : i + k] for i in range(n)})
    return distinct / min(4 ** k, n)
