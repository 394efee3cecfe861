"""The roofline counts against hand counts, and the trace arithmetic."""

import pytest

from svbench import roofline
from svbench.roofline import kmer, sw
from svbench.trace import _union

PEAK = {"int32_ops_per_s": 1e12, "hbm_bytes_per_s": 1e11}


def test_sw_work_by_hand():
    # 2 pairs: 3x4 and 5x2 unpadded cells; 14 input bases; 2 x 12 bytes out
    calls = [(2, 8, 8, 3 * 4 + 5 * 2, 3 + 4 + 5 + 2)]
    ops_s = 22 * 7 / 1e12
    bytes_s = (14 + 24) / 1e11
    assert sw.least_seconds(calls, PEAK) == pytest.approx(max(ops_s, bytes_s))
    big = [(1, 1000, 1000, 10**6, 2000)]
    assert sw.least_seconds(big, PEAK) == pytest.approx(7e6 / 1e12)


def test_kmer_work_by_hand():
    # reads of 100 and 20 bases at k=15 (86 + 6 windows), a 300-base
    # reference (286), no normal; 10 k-mers out
    windows = 86 + 6 + 286
    calls = [(windows, 100 + 20 + 300, 10)]
    want = max(windows * 3 / 1e12, (420 + 80) / 1e11)
    assert kmer.least_seconds(calls, PEAK) == pytest.approx(want)


def test_share_counts_only_the_familys_kernels():
    ks = {"void sw_wavefront_kernel<4>(...)": 2e-3, "region_kmers_kernel": 1e-3, "Memcpy HtoD": 5e-3}
    assert roofline.share_pct(1e-3, ks, sw.KERNELS) == pytest.approx(50.0)
    assert roofline.share_pct(1e-3, ks, ("absent",)) is None


def test_peaks_are_declared_for_the_h100():
    p = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert p["int32_ops_per_s"] == pytest.approx(132 * 64 * 1.98e9, rel=1e-3)
    assert roofline.peaks("some other card") is None


def test_union_of_intervals():
    assert _union([(5, 8), (0, 2), (1, 3), (8, 9)]) == [(0, 3), (5, 9)]
