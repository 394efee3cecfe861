"""A lane-axis running max on the card.

Port of ``tools/probe_mosaic_cummax.py``, which asked whether Mosaic
lowers ``lax.cummax`` / ``jnp.maximum.accumulate`` (one function) inside
a kernel: ``cummax`` runs the hand-written kernel ``csrc/probe_cummax.cu``
on a CUDA tensor and its plain version, ``torch.cummax(x, 1).values``, on
a CPU tensor. On the probe's [8, 256] int32 input (seed 0):

    python -m breakmer_tpu_torch.tools.probe_mosaic_cummax

prints whether the kernel is exact against the plain version and both
times in microseconds: a call's wall time (launch-bound at this shape)
and its device time.
"""

from __future__ import annotations

import numpy as np
import torch

SHAPE = (8, 256)

# kernel launches made by cummax (one per call on a CUDA tensor)
LAUNCHES = 0


def inputs() -> np.ndarray:
    """The TPU probe's input: [8, 256] int32 in 0..99 from seed 0."""
    return np.random.default_rng(0).integers(0, 100, SHAPE, np.int32)


def cummax_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 1).values


def cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max along dim 1 of [R, W] int32 (W <= 1024):
    the kernel on a CUDA tensor (launches or raises), the plain version on
    a CPU tensor."""
    global LAUNCHES
    if x.device.type == "cpu":
        return cummax_plain(x)
    from breakmer_tpu_torch import _build

    if x.device.type != "cuda":
        raise ValueError(f"cummax: no kernel for device {x.device}")
    if x.dtype != torch.int32 or x.dim() != 2 or not 1 <= x.shape[1] <= 1024:
        raise ValueError(f"cummax: [R, W <= 1024] int32 required, got "
                         f"{tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.probe_cummax_launch(x.data_ptr(), out.data_ptr(), x.shape[0],
                                      x.shape[1], _build.stream_of(x))
    _build.check_launch(err, f"probe_cummax {tuple(x.shape)}")
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
