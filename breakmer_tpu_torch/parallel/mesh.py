"""Device-mesh construction helpers.

Port of ``breakmer_tpu/parallel/mesh.py``. JAX's ``jax.sharding.Mesh``
becomes ``Mesh`` below: a numpy object array of ``torch.device`` with
one dimension per named axis. A device may appear more than once: that
is a virtual mesh, several shards on one card (or on the CPU, as in the
tests), each shard still computed on its own and gathered like the
others. The sharded forms (``parallel/step.py``, ``parallel/kmer_batch.py``,
``parallel/index_shard.py``) run each shard under ``on_device`` and
gather with ``gather``, the counterpart of ``jax.lax.all_gather`` with
``tiled=True``.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_REGIONS = "regions"
AXIS_PAIRS = "pairs"


class Mesh:
    """``devices`` (numpy object array of torch.device, one dimension an
    axis) and ``axis_names``, as ``jax.sharding.Mesh`` has them."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names) or devices.size == 0:
            raise ValueError(f"mesh of shape {devices.shape} with axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def first(self) -> torch.device:
        """The device the gathers land on (JAX's ``out_specs=P()``)."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        shape = ", ".join(f"{n}={s}" for n, s in zip(self.axis_names, self.devices.shape))
        return f"Mesh({shape}: {[str(d) for d in self.devices.flat]})"


def device_array(devices: Sequence[torch.device], shape: Tuple[int, ...]) -> np.ndarray:
    """``devices`` as a numpy object array of ``shape`` (row-major)."""
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return arr.reshape(shape)


def mesh_devices(n_devices: Optional[int], devices: Optional[Sequence]) -> List[torch.device]:
    """The devices of a new mesh: ``devices`` (default every visible
    card), the first ``n_devices`` of them if given."""
    if devices is None:
        from breakmer_tpu_torch.device import local_devices

        devices = local_devices("cuda")
    devices = list(devices)
    if n_devices is not None:
        if not 0 < n_devices <= len(devices):
            raise ValueError(f"n_devices={n_devices}: {len(devices)} devices available")
        devices = devices[:n_devices]
    return devices


def mesh_axes() -> Tuple[str, str]:
    return (AXIS_REGIONS, AXIS_PAIRS)


def _factor_2d(n: int) -> Tuple[int, int]:
    """Largest factor pair (a, b) with a*b == n and a >= b, a the regions
    axis (regions parallelism is the dominant dimension, like the
    reference's process pool)."""
    best = (n, 1)
    f = 1
    while f * f <= n:
        if n % f == 0:
            best = (n // f, f)
        f += 1
    return best


def make_mesh_2d(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """Mesh over (regions, pairs). ``devices`` defaults to every visible
    card; it may name a device more than once (a virtual mesh)."""
    devices = mesh_devices(n_devices, devices)
    return Mesh(device_array(devices, _factor_2d(len(devices))), (AXIS_REGIONS, AXIS_PAIRS))


def on_device(device: torch.device):
    """Context in which a shard's work runs: the card's own current
    device (so a kernel launches on that card's current stream), nothing
    on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def split_evenly(n: int, parts: int, what: str) -> List[slice]:
    """``parts`` contiguous blocks of ``n``; raises unless they are equal
    (as ``shard_map`` does)."""
    if n % parts:
        raise ValueError(f"{what} = {n} does not split evenly over {parts} shards")
    size = n // parts
    return [slice(i * size, (i + 1) * size) for i in range(parts)]


def gather(parts: Sequence[torch.Tensor], device: torch.device, dim: int = 0) -> torch.Tensor:
    """The shards concatenated along ``dim`` on ``device``
    (``all_gather(..., tiled=True)`` onto one device). A copy from
    another card follows PyTorch's cross-device stream order."""
    return torch.cat([p.to(device) for p in parts], dim=dim)
