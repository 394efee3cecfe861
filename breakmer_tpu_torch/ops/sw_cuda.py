"""Wrapper of the hand-written CUDA Smith-Waterman kernel
(``csrc/sw_wavefront.cu``), the port of
``breakmer_tpu/ops/sw_pallas.py::sw_score_pallas``.

The kernel library is built and loaded on the first call, never at
import, so this module imports on a machine without ``nvcc`` or a card.
The kernel runs on PyTorch's current stream and allocates nothing: the
wrapper computes the launch plan (``launch_plan``, plain Python that the
CPU tests reach) and allocates the outputs and, for a query longer than
one strip, the zeroed scratch that links the strips of a pair.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from breakmer_tpu_torch import _build
from breakmer_tpu_torch.ops.sw import SWParams

# kernel launches made by sw_score_cuda (one per call with B > 0)
LAUNCHES = 0
_LAUNCH = None  # the kernel library's sw_wavefront_launch, at the first launch

ROWS_PER_LANE = (4, 8)  # the kernel's instantiations of R
WARPS_PER_BLOCK = 4         # 128 threads, the kernel's __launch_bounds__
SMS = 132                   # H100 SXM; launch_plan takes the card's own count
# At each R: the clocks a warp spends on one step alone on its SM
# partition, its share of a partition that holds four warps, and the steps
# a strip runs behind the one above it. Measured on an NVIDIA H100 80GB
# HBM3 at 700 W by chip_smoke.py's step-cost table (sw_step_costs).
STEP_CYCLES = {4: (217, 113, 149), 8: (274, 171, 127)}
_GAP_LIMIT = 1 << 20        # |scoring parameter| bound that keeps NEG from wrapping


class LaunchPlan(NamedTuple):
    """How one launch covers B pairs of Lq x Lt: strips of 32 * R query
    rows, one warp a strip (``warps`` = B * strips work items, taken in
    (pair, strip) order), ``blocks`` blocks of ``threads`` threads; for
    strips > 1 one zeroed int32 scratch of ``scratch_ints``: a header of
    ``header_ints`` (ticket, done a pair, each strip's best) padded to 16
    bytes, then the boundary rows, one (H, j + 1, F, j + 1) line a column.
    ``pack``: a row's best is one key (scores < 2^15, Lt <= 2^16)."""
    rows_per_lane: int
    strips: int
    warps: int
    threads: int
    blocks: int
    pack: bool
    header_ints: int
    scratch_ints: int
    smem_bytes: int = 0  # the kernel keeps its state in registers


def _strips(Lq: int, R: int) -> int:
    return -(-Lq // (32 * R))


def step_clocks(B: int, Lq: int, Lt: int, R: int, sms: int = SMS) -> float:
    """Estimated clocks of a launch at R: its steps (a strip's columns plus
    the lane ramp, and the lag of each strip after the first) times a
    step's clocks, the warp's own while its SM partition is not full, its
    share of the partition when the warps outnumber the partitions."""
    S = _strips(Lq, R)
    alone, shared, lag = STEP_CYCLES[R]
    per_partition = B * S / (4 * sms)
    return (Lt + 31 + (S - 1) * lag) * max(alone, shared * per_partition)


def _rows_per_lane(B: int, Lq: int, Lt: int, sms: int) -> int:
    """The R of the fewest estimated clocks: a larger R costs less a cell,
    a smaller one gives a launch of few pairs more warps."""
    return min(ROWS_PER_LANE, key=lambda R: (step_clocks(B, Lq, Lt, R, sms), -R))


def launch_plan(B: int, Lq: int, Lt: int, rows_per_lane: Optional[int] = None,
                sms: int = SMS, match: int = 2) -> LaunchPlan:
    """The launch of ``sw_score_cuda`` for B pairs of Lq x Lt on a card of
    ``sms`` SMs; ``rows_per_lane`` forces R (one of ``ROWS_PER_LANE``)."""
    R = _rows_per_lane(B, Lq, Lt, sms) if rows_per_lane is None else rows_per_lane
    if R not in ROWS_PER_LANE:
        raise ValueError(f"rows_per_lane {R} not in {ROWS_PER_LANE}")
    S = _strips(Lq, R)
    warps = B * S
    header = 1 + B + 3 * warps if S > 1 else 0
    return LaunchPlan(
        rows_per_lane=R, strips=S, warps=warps, threads=32 * WARPS_PER_BLOCK,
        blocks=-(-warps // WARPS_PER_BLOCK),
        pack=match * min(Lq, Lt) < (1 << 15) and Lt <= (1 << 16),
        header_ints=header,
        scratch_ints=-(-header // 4) * 4 + 4 * B * (S - 1) * Lt)


def sw_score_cuda(
    q: torch.Tensor, t: torch.Tensor, params: SWParams = SWParams(),
    no_n: bool = False, rows_per_lane: Optional[int] = None, unpacked: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same contract as ``ops.sw.sw_score`` for CUDA tensors: q [B, Lq]
    and t [B, Lt] int8 on one card; returns (score, q_end, t_end), each
    [B] int32 on that card. Raises on anything the kernel does not take
    and on a launch the CUDA runtime refuses.

    no_n: caller asserts no mid-sequence N in either input; takes the
    compare-and-select substitution (bit-identical results). Ignored
    unless mismatch > 0 and gap_extend > 0, which the exactness argument
    needs (as in the TPU kernel). rows_per_lane: force the plan's R;
    unpacked: keep a row's best as score and column apart, the form the
    plan takes past the packed key's range, at any shape (the card tests
    hold every instantiation against the plain version)."""
    global LAUNCHES, _LAUNCH

    if q.device.type != "cuda" or t.device != q.device:
        raise ValueError(f"sw_score_cuda: q on {q.device}, t on {t.device}; "
                         "both must be on one CUDA device")
    if q.dtype != torch.int8 or t.dtype != torch.int8:
        raise TypeError(f"sw_score_cuda: int8 codes required, got {q.dtype}, {t.dtype}")
    if q.dim() != 2 or t.dim() != 2 or q.shape[0] != t.shape[0]:
        raise ValueError(f"sw_score_cuda: shapes {tuple(q.shape)}, {tuple(t.shape)}")
    B, Lq = q.shape
    Lt = t.shape[1]
    if Lq < 1 or Lt < 1:
        raise ValueError(f"sw_score_cuda: empty sequences (Lq={Lq}, Lt={Lt})")
    if params.match * min(Lq, Lt) >= (1 << 28) or Lq + Lt >= (1 << 30):
        raise ValueError("score range exceeds int32")
    if any(abs(x) >= _GAP_LIMIT for x in params) or abs(params.gap_extend) * Lt >= (1 << 26):
        raise ValueError(f"sw_score_cuda: scoring parameters {tuple(params)} out of range")
    # the no_n form's score table holds match and -mismatch as bytes
    no_n = (bool(no_n) and params.mismatch > 0 and params.gap_extend > 0
            and params.match <= 127 and params.mismatch <= 128)
    q = q.contiguous()
    t = t.contiguous()
    out = torch.empty((3, B), dtype=torch.int32, device=q.device)
    score, q_end, t_end = out
    if B == 0:
        return score, q_end, t_end

    plan = launch_plan(B, Lq, Lt, rows_per_lane, _sms(q.device), params.match)
    if unpacked:
        plan = plan._replace(pack=False)
    header = bnd = None
    if plan.strips > 1:
        scratch = torch.zeros(plan.scratch_ints, dtype=torch.int32, device=q.device)
        header = scratch.data_ptr()
        bnd = header + 4 * (plan.scratch_ints - 4 * B * (plan.strips - 1) * Lt)
    if _LAUNCH is None:
        _LAUNCH = _build.library().sw_wavefront_launch
    _build.launch(
        _LAUNCH, q.get_device(), lambda: f"sw_wavefront (B={B}, Lq={Lq}, Lt={Lt}, {plan})",
        q.data_ptr(), t.data_ptr(), B, Lq, Lt,
        params.match, params.mismatch, params.gap_open, params.gap_extend,
        int(no_n), int(plan.pack), plan.rows_per_lane, plan.blocks, plan.threads,
        header, bnd, score.data_ptr(), q_end.data_ptr(), t_end.data_ptr(),
    )
    LAUNCHES += 1
    return score, q_end, t_end


_SMS: dict = {}


def _sms(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]
