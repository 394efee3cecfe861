"""Device selection.

``Config.device`` names where the k-mer engine and the SW kernel run:

  "cuda" or "cuda:N": the card; raises when no CUDA device is present.
  "auto" (default): the same as "cuda". It never falls back to the CPU,
      so that a run cannot quietly leave the card idle: without a card
      it raises and says to pass device=cpu.
  "cpu": the plain torch versions on the CPU (what the CPU tests use).

(The JAX package's "auto" falls back to the CPU silently; the port
diverges on purpose.)
"""

from __future__ import annotations

from typing import List

import torch


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
    sharded index take their devices from here alone."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]
