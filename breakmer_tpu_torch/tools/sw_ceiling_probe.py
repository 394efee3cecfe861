"""What bounds the SW kernel on the card: the wavefront loop stripped to
its per-step exchange, beside the production kernel.

Port of ``tools/sw_ceiling_probe.py``. ``stripped`` runs the probe's
loop (four int32 state vectors a row; per step three lane rolls and a
max, ``rolls3``, or the rolls replaced by elementwise maxes, ``rolls0``)
as the hand-written kernel ``csrc/sw_ceiling_probe.cu`` on a CUDA tensor
and as ``stripped_plain`` on a CPU tensor. ``main`` times both forms and
the production kernel (``sw_score_cuda(..., no_n=True)``) at the bench
shape 512 x (256 x 512), each as device time of queued calls
(``timing.queued_ms``; a call's host launch path is longer than rolls3
itself), and prints one JSON line:

    python -m breakmer_tpu_torch.tools.sw_ceiling_probe

The kernel strips the current SW kernel, ``csrc/sw_wavefront.cu``: one
warp a row, R = ``plan(Lq).per_thread`` query lanes a thread in
registers (8 at Lq = 256, as the SW plan has it there), and per step the
three values the SW kernel passes down the warp (H, F and the target
code) as three warp shuffles, with no shared memory and no barrier. So
``roll_bound_fraction`` = rolls3 / full is the share of the SW kernel's
device time that its per-step exchange and a max a lane set: near 1, the
kernel is exchange-bound; well under 1, its cell arithmetic costs the
rest. rolls0 keeps the registers and the loop without the shuffles.
"""

from __future__ import annotations

import functools
import json
from typing import Optional

import numpy as np
import torch

from breakmer_tpu_torch import _build
from breakmer_tpu_torch.tools import warp_layout

B, LQ, LT = 512, 256, 512
U = 8  # the TPU loop's unroll; the default step count is a multiple of it
R_CHOICES = (1, 2, 4, 8, 16)  # the kernel's lanes a thread: Lq <= 512

# kernel launches made by stripped (one per call on a CUDA tensor)
LAUNCHES = 0
_LAUNCH = None  # the kernel library's sw_ceiling_probe_launch, at the first launch


@functools.lru_cache(maxsize=None)
def plan(Lq: int) -> warp_layout.Layout:
    """The kernel's layout of a row of Lq lanes: ``per_thread`` is its R
    (8 at the probe's Lq = 256); raises ValueError unless 1 <= Lq <= 512."""
    return warp_layout.layout(Lq, R_CHOICES)


def default_steps(Lq: int, Lt: int) -> int:
    """The probe's step count: one per anti-diagonal, rounded up to U."""
    return -(-(Lq + Lt - 1) // U) * U


def stripped_plain(q: torch.Tensor, t: torch.Tensor, do_rolls: bool,
                   steps: Optional[int] = None) -> torch.Tensor:
    """The probe's loop as torch ops: q [B, Lq] and t [B, Lt >= Lq] int8
    -> [B, Lq] int32. At the default step count (> Lq) every lane of a
    row ends at the row's maximum; ``steps`` stops earlier, where the
    roll direction and the wrap at lane 0 still show."""
    Lq = q.shape[1]
    steps = default_steps(Lq, t.shape[1]) if steps is None else steps
    hd1 = q.to(torch.int32)
    hd2 = torch.zeros_like(hd1)
    fd1 = torch.zeros_like(hd1)
    tj = t[:, :Lq].to(torch.int32)
    for _ in range(steps):
        if do_rolls:
            a, b, c = (torch.roll(x, 1, 1) for x in (hd2, fd1, tj))
        else:
            a, b, c = (torch.clamp_min(x, v) for x, v in ((hd2, 1), (fd1, 2), (tj, 3)))
        h = torch.maximum(torch.maximum(a, b), torch.maximum(c, hd1))
        hd2, hd1, fd1, tj = hd1, h, b, c
    return hd1


def stripped(q: torch.Tensor, t: torch.Tensor, do_rolls: bool,
             steps: Optional[int] = None) -> torch.Tensor:
    """``stripped_plain``'s result; on a CUDA tensor from the kernel (it
    launches or raises), on a CPU tensor from the plain version."""
    global LAUNCHES, _LAUNCH
    if q.device.type == "cpu" and t.device.type == "cpu":
        return stripped_plain(q, t, do_rolls, steps)
    index = q.get_device()
    if index < 0 or t.get_device() != index:
        raise ValueError(f"stripped: q on {q.device}, t on {t.device}; "
                         "both must be on one CUDA device")
    if q.dtype is not torch.int8 or t.dtype is not torch.int8:
        raise TypeError(f"stripped: int8 codes required, got {q.dtype}, {t.dtype}")
    if q.dim() != 2 or t.dim() != 2 or q.shape[0] != t.shape[0] or t.shape[1] < q.shape[1]:
        raise ValueError(f"stripped: shapes {tuple(q.shape)}, {tuple(t.shape)}")
    if not (q.is_contiguous() and t.is_contiguous()):
        raise ValueError("stripped: contiguous q and t required")
    Bq, Lq = q.shape
    Lt = t.shape[1]
    steps = default_steps(Lq, Lt) if steps is None else int(steps)
    if steps < 0:
        raise ValueError(f"stripped: steps={steps}")
    out = torch.empty_like(q, dtype=torch.int32)
    if Bq == 0 or Lq == 0:
        return out
    R = plan(Lq).per_thread
    if _LAUNCH is None:
        _LAUNCH = _build.library().sw_ceiling_probe_launch
    _build.launch(_LAUNCH, index, "sw_ceiling_probe", q.data_ptr(), t.data_ptr(), Bq, Lq, Lt,
                  steps, int(bool(do_rolls)), R, out.data_ptr())
    LAUNCHES += 1
    return out


def inputs(device) -> tuple:
    """The probe's inputs (seed 0): q [B, LQ], t [B, LT] int8 codes 0..3."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, (B, LQ), dtype=np.int8)
    t = rng.integers(0, 4, (B, LT), dtype=np.int8)
    return torch.from_numpy(q).to(device), torch.from_numpy(t).to(device)


def measure(device) -> dict:
    """The probe's numbers on the card, each the device time of queued
    calls (the caller has checked the kernel against the plain version)."""
    from breakmer_tpu_torch.ops.sw_cuda import sw_score_cuda
    from breakmer_tpu_torch.timing import card_line, queued_ms

    q, t = inputs(device)
    cells = B * LQ * LT
    t3 = queued_ms(lambda: stripped(q, t, True)) / 1e3
    t0 = queued_ms(lambda: stripped(q, t, False)) / 1e3
    tf = queued_ms(lambda: sw_score_cuda(q, t, no_n=True)) / 1e3
    return {
        "metric": "sw_ceiling_probe",
        "shape": [B, LQ, LT],
        "steps": default_steps(LQ, LT),
        "rolls3_s": t3,
        "rolls0_s": t0,
        "full_s": tf,
        "rolls3_gcups_equiv": cells / t3 / 1e9,
        "rolls0_gcups_equiv": cells / t0 / 1e9,
        "full_gcups": cells / tf / 1e9,
        "roll_bound_fraction": t3 / tf,
        "card": card_line(),
    }


def check(device, steps_list=(1, 7, 255, None)) -> None:
    """Kernel against the plain version on the card, both forms, at each
    step count (the short ones show the roll direction and the wrap at
    lane 0 before the output saturates); raises on a difference."""
    q, t = inputs(device)
    for do_rolls in (True, False):
        for steps in steps_list:
            want = stripped_plain(q, t, do_rolls, steps)
            got = stripped(q, t, do_rolls, steps)
            err = int((want - got).abs().max())
            if err:
                raise RuntimeError(f"sw_ceiling_probe kernel != plain "
                                   f"(rolls={do_rolls}, steps={steps}): max err {err}")


def main() -> None:
    from breakmer_tpu_torch.device import resolve

    device = resolve("cuda")
    check(device)
    print(json.dumps(measure(device)))


if __name__ == "__main__":
    main()
