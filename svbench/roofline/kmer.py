"""The k-mer engine: the region kernel (csrc/region_kmers.cu), the batch
step's kernels (csrc/kmer.cu) and their sorts.

A call's work: every k-mer window of the sample's reads, of the region's
reference and of the normal's reads (unpadded), at 3 integer operations
a window (shift, or, mask); bytes: each base read once (one byte) and the
sample-only k-mer set written once (a 4-byte code and a 4-byte count
each)."""

KERNELS = ("region_kmers", "kmer_codes", "revcomp_kmers", "unique_counts", "subtract_sorted",
           "RadixSort", "radixSort", "radix_sort", "SortKernel", "sort_kernel")
OPS_PER_WINDOW = 3
BYTES_PER_KMER_OUT = 8


def least_seconds(calls, peak: dict) -> float:
    """``calls``: (windows, bases, k-mers out) per call."""
    total = 0.0
    for windows, bases, out in calls:
        ops = windows * OPS_PER_WINDOW
        nbytes = bases + out * BYTES_PER_KMER_OUT
        total += max(ops / peak["int32_ops_per_s"], nbytes / peak["hbm_bytes_per_s"])
    return total
