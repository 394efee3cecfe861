"""Device selection.

``Config.device`` names where the k-mer engine and the SW kernel run:

  "cuda" or "cuda:N": the card; raises when no CUDA device is present.
  "auto" (default): the same as "cuda". It never falls back to the CPU,
      so that a run cannot quietly leave the card idle: without a card
      it raises and says to pass device=cpu.
  "cpu": the plain torch versions on the CPU (what the CPU tests use).

(The JAX package's "auto" falls back to the CPU silently; the port
diverges on purpose.)

``virtual_devices(devices)`` stands in for the JAX tests' virtual CPU
devices: inside it, ``local_devices`` gives ``devices`` (which may repeat
one device), so the runner's mesh and sharded index run over them.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence

import torch

_virtual: Optional[List[torch.device]] = None  # set by virtual_devices


def resolve(device="auto") -> torch.device:
    """The torch.device for a ``Config.device`` value."""
    name = str(device)
    if name == "cpu":
        return torch.device("cpu")
    if name == "auto" or name == "cuda" or name.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={name}: no CUDA device is available; pass "
                "device=cpu to run on the CPU"
            )
        return torch.device("cuda" if name == "auto" else name)
    raise ValueError(f"device={name!r}: expected auto, cuda, cuda:N or cpu")


def local_devices(device="auto") -> List[torch.device]:
    """The devices a process shards its work over, the counterpart of
    ``jax.local_devices()``: every visible card for "auto" and "cuda",
    the one named device for "cuda:N" and "cpu". The runner's mesh and
    sharded index take their devices from here alone. Inside
    ``virtual_devices`` it gives that context's devices, whatever it is
    asked."""
    if _virtual is not None:
        return list(_virtual)
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


@contextlib.contextmanager
def virtual_devices(devices: Sequence) -> Iterator[List[torch.device]]:
    """Within the ``with`` block, ``local_devices`` returns ``devices``
    (a virtual mesh when a device repeats: ``[cuda:0] * 4`` on one card,
    ``[cpu] * 4`` in the tests); the previous devices come back on exit,
    also after an exception."""
    global _virtual
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("virtual_devices: no devices given")
    prev, _virtual = _virtual, devs
    try:
        yield list(devs)
    finally:
        _virtual = prev
