"""Smith-Waterman (csrc/sw_wavefront.cu, both launch forms).

A call's work: cells = sum over its pairs of Lq x Lt (unpadded), at the
recurrence's fixed 7 integer-pipe operations a cell (the DPX three-input
max counted once); bytes: each input base read once (one byte) and each
pair's score, q_end and t_end written once (12 bytes)."""

KERNELS = ("sw_wavefront",)
OPS_PER_CELL = 7
OUT_BYTES_PER_PAIR = 12


def least_seconds(calls, peak: dict) -> float:
    """``calls``: (pairs, Lq, Lt, cells, input bases) per call."""
    total = 0.0
    for pairs, _lq, _lt, cells, bases in calls:
        ops = cells * OPS_PER_CELL
        nbytes = bases + pairs * OUT_BYTES_PER_PAIR
        total += max(ops / peak["int32_ops_per_s"], nbytes / peak["hbm_bytes_per_s"])
    return total
