"""int16 building blocks of an int16 SW state, on the card.

Port of ``tools/probe_swar_i16.py``: the same 13 probe bodies on the same
[16, 256] inputs (seed 0), each as an op of the hand-written kernel
``csrc/probe_i16.cu`` (row-pair packed s16x2 words, Hopper DPX where it
fits; one warp a row pair, the words in registers, a lane roll as one
warp shuffle; ``plan`` is its layout) beside its plain version, int16
torch ops on the unpacked [16, 256] tensors. The TPU probe asked which
ops Mosaic lowers; here every op builds, so the question is whether the
packed kernel is exact against the plain version, and what each costs:

    python -m breakmer_tpu_torch.tools.probe_swar_i16

prints one line per op: its name, ``exact=True/False``, and the kernel's
and the plain version's time in microseconds, as a call's wall time
(CUDA events; both launch-bound at this shape) and as device time
(``torch.profiler``, the kernels alone; and queued calls back to back,
``timing.queued_ms``). ``probe_swar_i16b`` shares the kernel, ``launch``
and ``run_ops``.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from breakmer_tpu_torch import _build
from breakmer_tpu_torch.tools import warp_layout

SHAPE = (16, 256)  # the TPU probe's shape (its int16 sublane tile is 16)
D = 77             # the diagonal index the best-update probes write
RW_CHOICES = (1, 2, 4, 8, 16, 32)  # the kernel's lanes a thread: W <= 1024

# kernel launches made by run_op (one per call on a CUDA tensor)
LAUNCHES = 0
_LAUNCH = None  # the kernel library's probe_i16_launch, at the first launch


I16, I32 = torch.int16, torch.int32


class Op(NamedTuple):
    name: str
    op_id: int              # the kernel's op (enum Op in csrc/probe_i16.cu)
    plain: Callable         # the plain version on torch tensors
    args: Tuple[str, ...]   # names of its inputs in the probe's inputs()
    out_dtype: torch.dtype = I16
    in_dtype: torch.dtype = I16


def inputs() -> dict:
    """The TPU probe's inputs, drawn in its order from seed 0."""
    rng = np.random.default_rng(0)
    x = {}
    x["A"] = rng.integers(-100, 100, SHAPE).astype(np.int16)
    x["B"] = rng.integers(-100, 100, SHAPE).astype(np.int16)
    x["M"] = rng.integers(0, 2, SHAPE).astype(np.int16) * -1
    x["A32"] = x["A"].astype(np.int32)
    x["H"] = rng.integers(0, 120, SHAPE).astype(np.int16)
    x["BH"] = rng.integers(0, 120, SHAPE).astype(np.int16)
    x["BD"] = rng.integers(0, 50, SHAPE).astype(np.int16)
    x["ONEHOT"] = np.zeros(SHAPE, np.int16)
    x["ONEHOT"][:, 0] = -1
    x["Q32"] = rng.integers(0, 4, SHAPE).astype(np.int32)
    x["T32"] = rng.integers(0, 4, SHAPE).astype(np.int32)
    return x


def roll1(x: torch.Tensor) -> torch.Tensor:
    """Lane roll by one: out[:, i] = x[:, i-1], lane 0 takes the last."""
    return torch.roll(x, 1, 1)


def substitution(q32: torch.Tensor, t32: torch.Tensor) -> torch.Tensor:
    """where(q == t, 2, -3) on int32 codes, as int16."""
    return torch.where(q32 == t32, 2, -3).to(torch.int16)


def _indicator(h, bh, bd):
    zero = torch.zeros_like(h)
    ind = torch.minimum(torch.maximum(h - bh, zero), torch.ones_like(h))
    return bd + ind * (D - bd)


def _onehot(x, m):
    return (roll1(x) & ~m) | (torch.full_like(m, -42) & m)


def _mini(q32, t32):
    sub = substitution(q32, t32)
    h = torch.clamp_min(sub, 0)
    e = torch.maximum(h - 6, h - 1)
    for _ in range(3):
        hr = roll1(h)
        e = torch.maximum(h - 6, e - 1)
        h = torch.maximum(torch.clamp_min(hr + sub, 0), e)
    return h


OPS = [
    Op("i16 maximum", 0, torch.maximum, ("A", "B")),
    Op("i16 minimum", 1, torch.minimum, ("A", "B")),
    Op("i16 add", 2, lambda a, b: a + b, ("A", "B")),
    Op("i16 sub const", 3, lambda a: a - 6, ("A",)),
    Op("i16 mul", 4, lambda a, b: a * b, ("A", "B")),
    Op("i16 and/or/xor/not", 5, lambda a, b, m: (a & ~m) | (b & m), ("A", "B", "M")),
    Op("i32->i16 astype", 6, lambda a: a.to(I16), ("A32",), in_dtype=I32),
    Op("i16->i32 astype", 7, lambda a: a.to(I32), ("A",), out_dtype=I32),
    Op("i16 compare-select", 8, lambda a, b: torch.where(a > b, a, b), ("A", "B")),
    Op("i16 roll (lanes)", 9, roll1, ("A",)),
    Op("indicator-select (bd update)", 10, _indicator, ("H", "BH", "BD")),
    Op("onehot shift-right select", 11, _onehot, ("A", "ONEHOT")),
    Op("fused mini-recurrence", 12, _mini, ("Q32", "T32"), in_dtype=I32),
]


@functools.lru_cache(maxsize=None)
def plan(W: int) -> warp_layout.Layout:
    """The kernel's layout of a row of W lanes: ``per_thread`` is its RW
    (8 at the probes' W = 256); raises ValueError unless 1 <= W <= 1024."""
    return warp_layout.layout(W, RW_CHOICES)


def refuse(op: Op, xs) -> None:
    """Raise the error that says why ``launch`` does not take ``xs``."""
    where = [str(x.device) for x in xs]
    if len(set(where)) > 1 or xs[0].device.type != "cuda":
        raise ValueError(f"{op.name}: inputs on {where}; all must be on one CUDA device")
    if any(x.dtype != op.in_dtype for x in xs):
        raise TypeError(f"{op.name}: {op.in_dtype} inputs required, "
                        f"got {[x.dtype for x in xs]}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{op.name}: contiguous inputs required")
    raise ValueError(f"{op.name}: shapes {[tuple(x.shape) for x in xs]}; one [R, W] "
                     "with R even and > 0 required")


def launch(op: Op, *xs: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/probe_i16.cu`` for ``op`` on contiguous CUDA
    tensors [R, W] of one card (R even, W <= 1024); raises on anything it
    does not take. The checks are plain compares, once a call; the launch
    goes through ``_build.launch``. Counts nothing: the probes'
    ``run_op`` count their own launches."""
    global _LAUNCH
    x0 = xs[0]
    index, shape = x0.get_device(), x0.shape
    for x in xs:
        if (x.get_device() != index or x.dtype is not op.in_dtype or x.shape != shape
                or not x.is_contiguous()):
            refuse(op, xs)
    if index < 0 or len(shape) != 2 or shape[0] % 2 or not shape[0]:
        refuse(op, xs)
    R, W = shape
    rw = plan(W).per_thread
    out = torch.empty_like(x0) if op.out_dtype is op.in_dtype else \
        torch.empty_like(x0, dtype=op.out_dtype)
    if _LAUNCH is None:
        _LAUNCH = _build.library().probe_i16_launch
    n = len(xs)
    _build.launch(_LAUNCH, index, op.name, op.op_id, x0.data_ptr(),
                  xs[1].data_ptr() if n > 1 else None, xs[2].data_ptr() if n > 2 else None,
                  out.data_ptr(), R, W, rw)
    return out


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


def run_ops(ops, run, arrays: dict, device) -> list:
    """Each op of ``ops`` through ``run`` on the card against its plain
    version, on the probe's numpy ``arrays``: one dict a op with
    ``exact``, the max abs error and the kernel's and the plain version's
    times in µs: a call's (``us``, CUDA events), the device's by the
    profiler (``device_us``) and of queued calls back to back
    (``queued_us``)."""
    from breakmer_tpu_torch.timing import cuda_ms, device_us, queued_ms

    x = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    rows = []
    for op in ops:
        xs = [x[name] for name in op.args]
        want = op.plain(*xs)
        got = run(op, *xs)
        err = int((want.to(I32) - got.to(I32)).abs().max())
        same = got.dtype == want.dtype and got.shape == want.shape
        rows.append(dict(name=op.name, exact=same and err == 0, max_abs_err=err,
                         us=cuda_ms(lambda: run(op, *xs), reps=20) * 1e3,
                         plain_us=cuda_ms(lambda: op.plain(*xs), reps=20) * 1e3,
                         device_us=device_us(lambda: run(op, *xs)),
                         plain_device_us=device_us(lambda: op.plain(*xs)),
                         queued_us=queued_ms(lambda: run(op, *xs)) * 1e3,
                         plain_queued_us=queued_ms(lambda: op.plain(*xs)) * 1e3))
    return rows


def main() -> None:
    from breakmer_tpu_torch.device import resolve

    rows = run_ops(OPS, run_op, inputs(), resolve("cuda"))
    print_rows(rows)


def print_rows(rows) -> None:
    from breakmer_tpu_torch.timing import card_line

    print(card_line())
    for r in rows:
        print(f"{r['name']:34s} exact={r['exact']}  kernel {r['us']:.2f} us "
              f"({r['device_us']:.2f} on the device, {r['queued_us']:.2f} queued)  "
              f"plain {r['plain_us']:.2f} us ({r['plain_device_us']:.2f}, "
              f"{r['plain_queued_us']:.2f})")
    n_ok = sum(r["exact"] for r in rows)
    print(f"{n_ok}/{len(rows)} exact")


if __name__ == "__main__":
    main()
