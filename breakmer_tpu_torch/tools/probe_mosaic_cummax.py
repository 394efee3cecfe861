"""A lane-axis running max on the card.

Port of ``tools/probe_mosaic_cummax.py``, which asked whether Mosaic
lowers ``lax.cummax`` / ``jnp.maximum.accumulate`` (one function) inside
a kernel: ``cummax`` runs the hand-written kernel ``csrc/probe_cummax.cu``
(one warp a row in the SW kernel's register layout; ``plan`` is its
launch) on a CUDA tensor and its plain version,
``torch.cummax(x, 1).values``, on a CPU tensor. On the probe's [8, 256]
int32 input (seed 0):

    python -m breakmer_tpu_torch.tools.probe_mosaic_cummax

prints whether the kernel is exact against the plain version and both
times in microseconds: a call's wall time (launch-bound at this shape)
and its device time.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from breakmer_tpu_torch import _build
from breakmer_tpu_torch.tools import warp_layout

SHAPE = (8, 256)
P_CHOICES = (1, 2, 4, 8, 16, 32)  # the kernel's lanes a thread: W <= 1024
MAX_WARPS = 8                     # rows a block, the kernel's __launch_bounds__
SMS = 132                         # H100 SXM

# kernel launches made by cummax (one per call on a CUDA tensor)
LAUNCHES = 0
_LAUNCH = None  # the kernel library's probe_cummax_launch, at the first launch


class Plan(NamedTuple):
    per_thread: int  # P, the kernel's template constant
    warps: int       # rows (warps) a block


def inputs() -> np.ndarray:
    """The TPU probe's input: [8, 256] int32 in 0..99 from seed 0."""
    return np.random.default_rng(0).integers(0, 100, SHAPE, np.int32)


@functools.lru_cache(maxsize=None)
def plan(R: int, W: int) -> Plan:
    """The launch of ``cummax`` on [R, W]: P from the warp layout, and the
    most warps a block (a power of two up to 8) that still leaves at
    least one block for each of the card's SMS SMs, so a few rows spread
    over as many SMs and many rows take fewer, fuller blocks. Raises
    ValueError unless R >= 1 and 1 <= W <= 1024."""
    if R < 1:
        raise ValueError(f"cummax: {R} rows")
    per_thread = warp_layout.layout(W, P_CHOICES).per_thread
    warps = 1
    while warps < MAX_WARPS and -(-R // (2 * warps)) >= SMS:
        warps *= 2
    return Plan(per_thread, warps)


def cummax_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 1).values


def cummax(x: torch.Tensor, warps: Optional[int] = None) -> torch.Tensor:
    """Inclusive running max along dim 1 of [R, W] int32 (W <= 1024):
    the kernel on a CUDA tensor (launches or raises), the plain version on
    a CPU tensor. ``warps`` forces the rows a block (1 to 8)."""
    global LAUNCHES, _LAUNCH
    index = x.get_device()
    if index < 0:
        if x.device.type == "cpu":
            return cummax_plain(x)
        raise ValueError(f"cummax: no kernel for device {x.device}")
    shape = x.shape
    if x.dtype is not torch.int32 or len(shape) != 2 or not 1 <= shape[1] <= 1024:
        raise ValueError(f"cummax: [R, W <= 1024] int32 required, got "
                         f"{tuple(shape)} {x.dtype}")
    if not x.is_contiguous():
        x = x.contiguous()
    out = torch.empty_like(x)
    R, W = shape
    if not R:
        return out
    p = plan(R, W)
    if warps is not None:
        if not 1 <= warps <= MAX_WARPS:
            raise ValueError(f"cummax: warps {warps} not in 1..{MAX_WARPS}")
        p = p._replace(warps=warps)
    if _LAUNCH is None:
        _LAUNCH = _build.library().probe_cummax_launch
    _build.launch(_LAUNCH, index, "probe_cummax", x.data_ptr(), out.data_ptr(), R, W,
                  p.per_thread, p.warps)
    LAUNCHES += 1
    return out


def measure(device) -> dict:
    """Kernel against the plain version on the probe's input, and both
    wall and device times (µs)."""
    from breakmer_tpu_torch.timing import cuda_ms, device_us

    x = torch.from_numpy(inputs()).to(device)
    err = int((cummax(x) - cummax_plain(x)).abs().max())
    return dict(exact=err == 0, max_abs_err=err,
                us=cuda_ms(lambda: cummax(x), reps=20) * 1e3,
                plain_us=cuda_ms(lambda: cummax_plain(x), reps=20) * 1e3,
                device_us=device_us(lambda: cummax(x)),
                plain_device_us=device_us(lambda: cummax_plain(x)))


def main() -> None:
    from breakmer_tpu_torch.device import resolve
    from breakmer_tpu_torch.timing import card_line

    r = measure(resolve("cuda"))
    print(card_line())
    print(f"running max {SHAPE} exact={r['exact']}  kernel {r['us']:.2f} us "
          f"({r['device_us']:.2f} on the device)  plain {r['plain_us']:.2f} us "
          f"({r['plain_device_us']:.2f})")


if __name__ == "__main__":
    main()
