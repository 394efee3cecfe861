"""int16 max emulated from sub, shift and and, on the card.

Port of ``tools/probe_swar_i16b.py``: the same 9 probe bodies on the same
[16, 256] inputs (seed 0), as ops of the kernel ``csrc/probe_i16.cu``
(shared with ``probe_swar_i16``, with its layout and launch path) beside
their plain int16 torch versions. The emulated max ``a - (d & (d >> 15))`` and the emulated
strict-greater select keep the TPU probe's arithmetic, so the kernel
shows whether that emulation is exact on the card and what it costs next
to the native s16x2 max of ``probe_swar_i16``:

    python -m breakmer_tpu_torch.tools.probe_swar_i16b

prints one line per op, as ``probe_swar_i16`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from breakmer_tpu_torch.tools.probe_swar_i16 import (
    D, I32, SHAPE, Op, launch, print_rows, refuse, roll1, run_ops, substitution,
)

# kernel launches made by run_op (one per call on a CUDA tensor)
LAUNCHES = 0


def inputs() -> dict:
    """The TPU probe's inputs, drawn in its order from seed 0."""
    rng = np.random.default_rng(0)
    x = {}
    x["A"] = rng.integers(-1000, 1000, SHAPE).astype(np.int16)
    x["B"] = rng.integers(-1000, 1000, SHAPE).astype(np.int16)
    x["Q32"] = rng.integers(0, 4, SHAPE).astype(np.int32)
    x["T32"] = rng.integers(0, 4, SHAPE).astype(np.int32)
    x["H"] = rng.integers(0, 120, SHAPE).astype(np.int16)
    x["BH"] = rng.integers(0, 120, SHAPE).astype(np.int16)
    x["BD"] = rng.integers(0, 50, SHAPE).astype(np.int16)
    return x


def emulated_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return a - (d & (d >> 15))


def _mini(q32, t32):
    zero = torch.zeros(q32.shape, dtype=torch.int16, device=q32.device)
    sub = substitution(q32, t32)
    h = emulated_max(sub, zero)
    e = h - 6
    for _ in range(3):
        hr = roll1(h)
        e = emulated_max(h - 6, e - 1)
        h = emulated_max(emulated_max(hr + sub, zero), e)
    return h


def _upd(h, bh, bd):
    m = (bh - h) >> 15  # all ones iff bh < h
    return (bd & ~m) | (torch.full_like(bd, D) & m)


OPS = [
    Op("i16 sub tensor", 13, lambda a, b: a - b, ("A", "B")),
    Op("i16 ashr 15", 14, lambda a: a >> 15, ("A",)),
    Op("i16 shl 1", 15, lambda a: a << 1, ("A",)),
    Op("i16 add splat-int16", 16, lambda a: a + torch.tensor(6, dtype=torch.int16), ("A",)),
    Op("i16 add py-int", 17, lambda a: a + 6, ("A",)),
    Op("i16 add full-array const", 18, lambda a: a + torch.full_like(a, 6), ("A",)),
    Op("i16 emulated max", 19, emulated_max, ("A", "B")),
    Op("fused mini (emulated max)", 20, _mini, ("Q32", "T32"), in_dtype=I32),
    Op("emulated strict-greater select", 21, _upd, ("H", "BH", "BD")),
]


def run_op(op: Op, *xs: torch.Tensor) -> torch.Tensor:
    """``op`` on CUDA tensors through the kernel (launches or raises), on
    CPU tensors through its plain version."""
    global LAUNCHES
    if xs[0].is_cuda:
        out = launch(op, *xs)
        LAUNCHES += 1
        return out
    if all(x.is_cpu for x in xs):
        return op.plain(*xs)
    refuse(op, xs)


def main() -> None:
    from breakmer_tpu_torch.device import resolve

    print_rows(run_ops(OPS, run_op, inputs(), resolve("cuda")))


if __name__ == "__main__":
    main()
