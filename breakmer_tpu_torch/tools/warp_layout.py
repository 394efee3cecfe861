"""The lane layout of the warp-a-row probe kernels, in Python.

``csrc/sw_ceiling_probe.cu`` and ``csrc/probe_i16.cu`` give each row (a
row pair, for the int16 probe) one warp of 32 threads. Thread ``l`` holds
the ``per_thread`` consecutive lanes ``l * per_thread`` ..
``l * per_thread + per_thread - 1`` in registers, where ``per_thread`` is
a template constant of the kernel: the smallest of its ``choices`` with
32 of them covering the width. A roll by one lane (``out[i] = x[i-1]``,
lane 0 takes the last lane, as ``torch.roll(x, 1, 1)``) is an in-thread
shift plus one warp shuffle from the thread before; thread 0 takes the
last lane from the thread that holds it (``holder``, element ``last``).
The wrappers pick the kernel's template from ``layout`` and refuse the
widths it refuses; the CPU tests hold ``roll_sources`` against
``torch.roll``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

WARP = 32


class Layout(NamedTuple):
    width: int
    per_thread: int  # lanes a thread: the kernel's template constant
    holder: int      # the thread that holds lane width - 1
    last: int        # lane width - 1's element in the holder


def layout(width: int, choices: Sequence[int]) -> Layout:
    """The layout of ``width`` lanes over one warp: ``per_thread`` is the
    smallest of ``choices`` with ``32 * per_thread >= width``; raises
    ValueError for a width under 1 or above ``32 * max(choices)``."""
    fits = [c for c in sorted(choices) if WARP * c >= width]
    if width < 1 or not fits:
        raise ValueError(f"width {width}: the kernel takes 1 to "
                         f"{WARP * max(choices)} lanes")
    per_thread = fits[0]
    holder, last = divmod(width - 1, per_thread)
    return Layout(width, per_thread, holder, last)


def roll_sources(lay: Layout) -> List[Tuple[int, int]]:
    """(thread, element) that each lane's roll reads, as the kernels
    compute it: the element before in the same thread, else the last
    element of the thread before, and for lane 0 the holder's ``last``."""
    out = []
    for i in range(lay.width):
        thread, k = divmod(i, lay.per_thread)
        if k:
            out.append((thread, k - 1))
        elif thread:
            out.append((thread - 1, lay.per_thread - 1))
        else:
            out.append((lay.holder, lay.last))
    return out
