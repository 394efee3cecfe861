"""Wrapper of the hand-written CUDA Smith-Waterman kernel
(``csrc/sw_wavefront.cu``), the port of
``breakmer_tpu/ops/sw_pallas.py::sw_score_pallas``.

The kernel library is built and loaded on the first call, never at
import, so this module imports on a machine without ``nvcc`` or a card.
The kernel runs on PyTorch's current stream and allocates nothing: the
wrapper computes the launch plan (``launch_plan``, plain Python that the
CPU tests reach) and allocates the outputs and, for a ticket-form launch
of a query longer than one strip, the zeroed scratch that links the
strips of a pair. The plan takes one of two forms: ``"ticket"`` (warps
take (pair, strip) items from an atomic ticket, strips linked through
global memory; R = 4 or 8) or, for a launch of at most FEW_PAIRS pairs,
``"block"`` (one block a pair, its strips linked through shared memory;
R = 2), whichever its clock model says is faster.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from breakmer_tpu_torch import _build
from breakmer_tpu_torch.ops.sw import NEG, SWParams

# kernel launches made by sw_score_cuda (one per call with B > 0), in all
# and by form
LAUNCHES = 0
LAUNCHES_BY_FORM = {"ticket": 0, "block": 0}
_LAUNCH = None  # the kernel library's sw_wavefront_launch, at the first launch
_BLOCK_LAUNCH = None  # and its sw_block_launch

ROWS_PER_LANE = (4, 8)  # the ticket form's instantiations of R
BLOCK_ROWS_PER_LANE = (2,)  # the block form's
FORMS = {"ticket": ROWS_PER_LANE, "block": BLOCK_ROWS_PER_LANE}
WARPS_PER_BLOCK = 4         # 128 threads, the ticket form's __launch_bounds__
BLOCK_MAX_STRIPS = 32       # the block form's 1024 threads, one warp a strip
SMEM_LIMIT = 227 * 1024     # shared memory a block may take on this card
RING, TPAD, TTAIL = 64, 32, 48  # the block form's ring and target pads
SMS = 132                   # H100 SXM; launch_plan takes the card's own count
# The plan weighs the block form only for launches of at most this many
# pairs: realign's serial rounds (1-12 pairs on the panel). The batched
# path's launches (25-239 pairs) and every larger one keep the ticket form.
FEW_PAIRS = 12
# At each R of the ticket form: the clocks a warp spends on one step alone
# on its SM partition, its share of a partition that holds four warps, and
# the steps a strip runs behind the one above it. At each R of the block
# form, whose strips share one SM: the clocks a column of a pair of four
# strips takes (one warp a partition), a warp's share of a column past
# that, and the steps each strip after the first adds. Measured on an
# NVIDIA H100 80GB HBM3 at 700 W by chip_smoke.py's step-cost table
# (sw_step_costs).
STEP_CYCLES = {2: (151, 74, 78), 4: (217, 113, 149), 8: (274, 171, 127)}
INT32 = (-(1 << 31), (1 << 31) - 1)
KEY_SCORES, KEY_COLUMNS = 1 << 15, 1 << 16  # what one packed row key holds
TPU_SCORE_LIMIT = 1 << 28  # match * min(Lq, Lt) the TPU kernel refuses at


class LaunchPlan(NamedTuple):
    """How one launch covers B pairs of Lq x Lt: strips of 32 * R query
    rows, one warp a strip (``warps`` = B * strips), ``blocks`` blocks of
    ``threads`` threads. ``form`` "ticket": the warps take work items in
    (pair, strip) order; for strips > 1 one zeroed int32 scratch of
    ``scratch_ints``: a header of ``header_ints`` (ticket, done a pair,
    each strip's best) padded to 16 bytes, then the boundary rows, one
    (H, j + 1, F, j + 1) line a column. ``form`` "block": block b is pair
    b, its warp k strip k, with ``smem_bytes`` of shared memory (the
    boundary rings, the strips' bests, the target) and no scratch.
    ``pack``: a row's best is one key H * 2^16 + 65535 - j, and E is kept
    as E + ge * j (``packs``); else score and column apart and E as the
    plain version has it."""
    rows_per_lane: int
    strips: int
    warps: int
    threads: int
    blocks: int
    pack: bool
    header_ints: int
    scratch_ints: int
    smem_bytes: int = 0  # the ticket form keeps its state in registers
    form: str = "ticket"


def _strips(Lq: int, R: int) -> int:
    return -(-Lq // (32 * R))


def form_of(R: int) -> str:
    """The form whose kernel is instantiated at rows a lane R."""
    for form, rs in FORMS.items():
        if R in rs:
            return form
    raise ValueError(f"rows_per_lane {R} not in {ROWS_PER_LANE + BLOCK_ROWS_PER_LANE}")


def block_smem_bytes(S: int, Lt: int) -> int:
    """The block form's shared memory (``csrc/sw_wavefront.cu``,
    ``block_smem_bytes``): S - 1 rings of RING (H, F) columns, a ready and
    a taken count each, S bests, padded to 16 bytes; then the target
    between its sentinel pads, padded to 16."""
    head = -(-(8 * RING * (S - 1) + 8 * (S - 1) + 12 * S) // 16) * 16
    return head + -(-(TPAD + Lt + TTAIL) // 16) * 16


def _fits(R: int, Lq: int, Lt: int) -> bool:
    """Whether the form of R takes a pair of Lq x Lt: the block form needs
    its strips in one block and its shared memory within the card's."""
    if form_of(R) == "ticket":
        return True
    S = _strips(Lq, R)
    return S <= BLOCK_MAX_STRIPS and block_smem_bytes(S, Lt) <= SMEM_LIMIT


def step_clocks(B: int, Lq: int, Lt: int, R: int, sms: int = SMS) -> float:
    """Estimated clocks of a launch at R (in R's form): its steps (a
    strip's columns plus the lane ramp, and the lag of each strip after
    the first) times a step's clocks, the warp's own while its SM
    partition is not full, its share of the partition when the warps
    outnumber the partitions (in the block form, the partitions of the
    SMs that hold the blocks)."""
    S = _strips(Lq, R)
    alone, shared, lag = STEP_CYCLES[R]
    if form_of(R) == "block":  # a block's warps share its SM
        per_partition = -(-B // sms) * S / 4
    else:
        per_partition = B * S / (4 * sms)
    return (Lt + 31 + (S - 1) * lag) * max(alone, shared * per_partition)


def _rows_per_lane(B: int, Lq: int, Lt: int, sms: int, rows=ROWS_PER_LANE) -> int:
    """The R of ``rows`` of the fewest estimated clocks: a larger R costs
    less a cell, a smaller one gives a launch of few pairs more warps."""
    return min(rows, key=lambda R: (step_clocks(B, Lq, Lt, R, sms), -R))


def score_bound(Lq: int, Lt: int, params: SWParams) -> int:
    """U, a bound of every H the plain version computes for a pair of Lq x
    Lt while its arithmetic stays in int32, for any sign of any parameter.
    An H above 0 is the score of a path from a relu restart: at most
    min(Lq, Lt) diagonal steps, each adding match or -mismatch (NEG at an
    N), and at most Lq + Lt gapped steps, a gap of g adding -go - ge (g - 1)
    <= g max(-go, -ge) (go = gap_open + gap_extend, ge = gap_extend). A path
    from E's NEG at column 0 or F's at row 0 scores less than from 0."""
    go = params.gap_open + params.gap_extend
    return (min(Lq, Lt) * max(params.match, -params.mismatch, 0)
            + (Lq + Lt) * max(-go, -params.gap_extend, 0))


def plain_in_int32(Lq: int, Lt: int, params: SWParams) -> bool:
    """Whether no value the plain version computes can leave int32: with P
    the largest of |match|, |mismatch|, |go|, |ge|, every value lies in
    [NEG - 2 P, U + P] (E and F of row 0 and column 0 start at NEG and
    lose at most 2 P before a path's first H >= 0 takes over)."""
    go = params.gap_open + params.gap_extend
    P = max(abs(params.match), abs(params.mismatch), abs(go), abs(params.gap_extend))
    return NEG - 2 * P >= INT32[0] and score_bound(Lq, Lt, params) + P <= INT32[1]


def packs(Lq: int, Lt: int, params: SWParams) -> bool:
    """Whether the packed form is exact for pairs of Lq x Lt: the plain
    version's values stay in int32 and below KEY_SCORES (U < 2^15), the
    columns fit the key (Lt <= 2^16), and the kernel's E + ge * j (j < Lt +
    32 counting the lanes' ramp) stays in int32: U + |go| + |ge| (Lt + 32)
    < 2^31. Past that the unpacked form takes the call."""
    if not plain_in_int32(Lq, Lt, params):
        return False
    U = score_bound(Lq, Lt, params)
    go = params.gap_open + params.gap_extend
    return (U < KEY_SCORES and Lt <= KEY_COLUMNS
            and U + abs(go) + abs(params.gap_extend) * (Lt + 32) <= INT32[1])


def launch_plan(B: int, Lq: int, Lt: int, rows_per_lane: Optional[int] = None,
                sms: int = SMS, params: SWParams = SWParams()) -> LaunchPlan:
    """The launch of ``sw_score_cuda`` for B pairs of Lq x Lt on a card of
    ``sms`` SMs: the form and R of the fewest estimated clocks among those
    that take the shape (the block form only for B <= FEW_PAIRS), packed
    where ``packs`` says the packed form is exact at ``params``.
    ``rows_per_lane`` forces R, and with it the form; a forced R that
    cannot take the shape raises."""
    if rows_per_lane is not None:
        form_of(rows_per_lane)  # raises for an R of no form
        rows = (rows_per_lane,)
    else:
        rows = ROWS_PER_LANE + (BLOCK_ROWS_PER_LANE if B <= FEW_PAIRS else ())
    rows = tuple(R for R in rows if _fits(R, Lq, Lt))
    if not rows:
        raise ValueError(f"the block form at R={rows_per_lane} cannot take "
                         f"Lq={Lq}, Lt={Lt} (at most {BLOCK_MAX_STRIPS} strips of 32 R "
                         f"rows and {SMEM_LIMIT} bytes of shared memory a block)")
    R = _rows_per_lane(B, Lq, Lt, sms, rows)
    S = _strips(Lq, R)
    warps = B * S
    pack = packs(Lq, Lt, params)
    if form_of(R) == "block":
        return LaunchPlan(rows_per_lane=R, strips=S, warps=warps, threads=32 * S, blocks=B,
                          pack=pack, header_ints=0, scratch_ints=0,
                          smem_bytes=block_smem_bytes(S, Lt), form="block")
    header = 1 + B + 3 * warps if S > 1 else 0
    return LaunchPlan(
        rows_per_lane=R, strips=S, warps=warps, threads=32 * WARPS_PER_BLOCK,
        blocks=-(-warps // WARPS_PER_BLOCK), pack=pack,
        header_ints=header,
        scratch_ints=-(-header // 4) * 4 + 4 * B * (S - 1) * Lt)


class Admission(NamedTuple):
    """What ``sw_score_cuda`` does with a call (``admit``): whether it takes
    the no_n form, and the launch (None: nothing to launch, at B = 0 or Lt
    = 0). The kernel gets the caller's parameters as they are."""
    no_n: bool
    plan: Optional[LaunchPlan]


@functools.lru_cache(maxsize=1024)  # shapes and parameters repeat from call to call
def admit(B: int, Lq: int, Lt: int, params: SWParams = SWParams(), no_n: bool = False,
          rows_per_lane: Optional[int] = None, unpacked: bool = False,
          sms: int = SMS) -> Admission:
    """The wrapper's decision for B pairs of Lq x Lt, shapes and parameters
    only (plain Python). Raises ``ValueError`` for exactly these: Lq = 0
    (as the JAX scan); a parameter outside int32 (the kernel's C ints);
    match * min(Lq, Lt) >= 2^28 (the TPU kernel's own refusal); Lq + Lt or
    Lt + 32 past 2^31 (the kernel's int32 step and diagonal counters); an
    R forced that the shape cannot take (``launch_plan``).

    The no_n form is taken where the caller asks for it, mismatch > 0 and
    gap_extend > 0 (the TPU kernel's conditions for the pads never to win),
    the plain version stays in int32, and both match and -mismatch fit a
    signed byte: its per-step score table holds them as bytes, read back
    sign-extended. Outside the packed form's range (``packs``) and where
    ``unpacked`` forces it, the kernel keeps E as the plain version does,
    so it computes the plain version's own int32 operations cell for cell:
    exact for every parameter the plain version does not wrap on, and as
    the plain version wraps where it does."""
    if Lq < 1:
        raise ValueError(f"sw_score_cuda: a query of no base (Lq={Lq})")
    if not all(INT32[0] <= x <= INT32[1] for x in (*params, params.gap_open + params.gap_extend)):
        raise ValueError(f"sw_score_cuda: scoring parameters {tuple(params)} outside int32")
    if params.match * min(Lq, Lt) >= TPU_SCORE_LIMIT:
        raise ValueError("score range exceeds int32")
    if Lq + Lt > INT32[1] or Lt + 32 > INT32[1]:
        raise ValueError(f"sw_score_cuda: Lq={Lq}, Lt={Lt} past the kernel's int32 counters")
    no_n = (bool(no_n) and plain_in_int32(Lq, Lt, params) and params.mismatch > 0
            and params.gap_extend > 0
            and -128 <= params.match <= 127 and params.mismatch <= 128)
    plan = None
    if B > 0 and Lt > 0:
        plan = launch_plan(B, Lq, Lt, rows_per_lane, sms, params)
        if unpacked:
            plan = plan._replace(pack=False)
    return Admission(no_n, plan)


def sw_score_cuda(
    q: torch.Tensor, t: torch.Tensor, params: SWParams = SWParams(),
    no_n: bool = False, rows_per_lane: Optional[int] = None, unpacked: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same contract as ``ops.sw.sw_score`` for CUDA tensors: q [B, Lq]
    and t [B, Lt] int8 on one card; returns (score, q_end, t_end), each
    [B] int32 on that card, what the plain version returns wherever its
    int32 arithmetic does not wrap. Raises ``ValueError`` before any launch
    where ``admit`` refuses, and on a launch the CUDA runtime refuses. At
    B = 0 or Lt = 0 it launches nothing: every pair gives (0, -1, -1).

    no_n: caller asserts every code is a base 0-3 or a trailing pad (no
    mid-sequence N, no code below 0); takes the compare-and-select
    substitution (bit-identical results) where ``admit`` says. Under it a
    code below 0 scores as a pad would (-mismatch against every code), not
    as the plain version's base. rows_per_lane: forces the plan's R, and
    with it the form (``launch_plan``; an R the shape cannot take raises
    before any launch); unpacked: keep a row's best as score and column
    apart and E as the plain version has it, the form the plan takes past
    the packed one's range, at any shape (the card tests hold every
    instantiation against the plain version)."""
    global LAUNCHES, _LAUNCH, _BLOCK_LAUNCH

    if q.device.type != "cuda" or t.device != q.device:
        raise ValueError(f"sw_score_cuda: q on {q.device}, t on {t.device}; "
                         "both must be on one CUDA device")
    if q.dtype != torch.int8 or t.dtype != torch.int8:
        raise TypeError(f"sw_score_cuda: int8 codes required, got {q.dtype}, {t.dtype}")
    if q.dim() != 2 or t.dim() != 2 or q.shape[0] != t.shape[0]:
        raise ValueError(f"sw_score_cuda: shapes {tuple(q.shape)}, {tuple(t.shape)}")
    B, Lq = q.shape
    Lt = t.shape[1]
    adm = admit(B, Lq, Lt, params, no_n, rows_per_lane, unpacked, _sms(q.device))
    out = torch.empty((3, B), dtype=torch.int32, device=q.device)
    score, q_end, t_end = out
    plan = adm.plan
    if plan is None:  # no pair, or no target column: no cell scores
        score.zero_()
        out[1:].fill_(-1)
        return score, q_end, t_end
    q = q.contiguous()
    t = t.contiguous()
    what = lambda: f"sw_wavefront (B={B}, Lq={Lq}, Lt={Lt}, {plan})"  # noqa: E731
    if plan.form == "block":
        if _BLOCK_LAUNCH is None:
            _BLOCK_LAUNCH = _build.library().sw_block_launch
        _build.launch(
            _BLOCK_LAUNCH, q.get_device(), what, q.data_ptr(), t.data_ptr(), B, Lq, Lt,
            params.match, params.mismatch, params.gap_open, params.gap_extend,
            int(adm.no_n), int(plan.pack), plan.rows_per_lane, plan.threads, plan.smem_bytes,
            score.data_ptr(), q_end.data_ptr(), t_end.data_ptr(),
        )
    else:
        header = bnd = None
        if plan.strips > 1:
            scratch = torch.zeros(plan.scratch_ints, dtype=torch.int32, device=q.device)
            header = scratch.data_ptr()
            bnd = header + 4 * (plan.scratch_ints - 4 * B * (plan.strips - 1) * Lt)
        if _LAUNCH is None:
            _LAUNCH = _build.library().sw_wavefront_launch
        _build.launch(
            _LAUNCH, q.get_device(), what, q.data_ptr(), t.data_ptr(), B, Lq, Lt,
            params.match, params.mismatch, params.gap_open, params.gap_extend,
            int(adm.no_n), int(plan.pack), plan.rows_per_lane, plan.blocks, plan.threads,
            header, bnd, score.data_ptr(), q_end.data_ptr(), t_end.data_ptr(),
        )
    LAUNCHES_BY_FORM[plan.form] += 1
    LAUNCHES += 1
    return score, q_end, t_end


_SMS: dict = {}


def _sms(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]
