"""Benchmark of the port on one card:

    python -m breakmer_tpu_torch.bench

Port of ``bench.py``. It times the hand-written SW kernel
(``ops/sw_cuda.py``) at the bench's two tiers, 512 x (256 x 512) and the
long-target 64 x (512 x 16384), and the fused region step
(``parallel/step.py``), and prints ONE JSON line. Before any timing it
checks on the card that the kernel, with ``no_n`` off and on, gives the
plain version's exact outputs at both tiers; a difference raises.

Keys of ``detail``, against ``bench.py``'s:
  sw_plain_gcups           (sw_xla_gcups)        the plain torch SW
  sw_cuda_gcups            (sw_pallas_gcups)     the kernel, no_n
  sw_cuda_nmasked_gcups    (sw_pallas_nmasked_gcups) the kernel, N tests on
  sw_gcups, sw_cells_per_batch, sw_longdp_gcups, device_step_regions_per_s,
  device_step_reads_per_s, region_step_ms        as there
  region_step_device_ms    (new) device time of a step (torch.profiler):
                           its share of region_step_ms is the card's busy
                           share in the step
``vs_baseline`` is gone: ``bench_baseline.json`` holds a TPU figure, which
is no baseline of the port; the line carries the card's name and power
limit instead. Times are CUDA-event medians (``timing.cuda_ms``). A
machine without a card raises: there is no CPU number under a card's
metric.
"""

from __future__ import annotations

import json

import numpy as np
import torch

# the SW tiers: a realistic panel realignment burst (contig pad tier 256,
# window 512), and long targets that amortise the wavefront's fill/drain
B, LQ, LT = 512, 256, 512
LONG_B, LONG_LQ, LONG_LT = 64, 512, 16384
# the region step: G regions of R reads of length L, references of LREF,
# GB SW pairs of GLQ x GLT per region, k-mer size K
G, R, L, LREF = 8, 256, 128, 4096
GB, GLQ, GLT = 16, 256, 512
K = 15
REPS = 5


def _gcups(cells: int, ms: float) -> float:
    return cells / ms / 1e6


def _check_sw(q, t) -> None:
    """The kernel (no_n off and on) against the plain version, exact."""
    from breakmer_tpu_torch.ops.sw import sw_score
    from breakmer_tpu_torch.ops.sw_cuda import sw_score_cuda

    want = sw_score(q, t)
    for no_n in (False, True):
        got = sw_score_cuda(q, t, no_n=no_n)
        if not all(torch.equal(a, b) for a, b in zip(want, got)):
            raise RuntimeError(f"SW kernel (no_n={no_n}) disagrees with the plain "
                               f"version at {tuple(q.shape)} x {t.shape[1]}")


def bench_sw(device) -> dict:
    from breakmer_tpu_torch.ops.sw import sw_score
    from breakmer_tpu_torch.ops.sw_cuda import sw_score_cuda
    from breakmer_tpu_torch.timing import cuda_ms

    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(0, 4, size=(B, LQ)).astype(np.int8)).to(device)
    t = torch.from_numpy(rng.integers(0, 4, size=(B, LT)).astype(np.int8)).to(device)
    ql = torch.from_numpy(
        rng.integers(0, 4, size=(LONG_B, LONG_LQ)).astype(np.int8)).to(device)
    tl = torch.from_numpy(
        rng.integers(0, 4, size=(LONG_B, LONG_LT)).astype(np.int8)).to(device)
    _check_sw(q, t)
    _check_sw(ql, tl)

    cells = B * LQ * LT
    plain = _gcups(cells, cuda_ms(lambda: sw_score(q, t), REPS))
    fast = _gcups(cells, cuda_ms(lambda: sw_score_cuda(q, t, no_n=True), REPS))
    nmasked = _gcups(cells, cuda_ms(lambda: sw_score_cuda(q, t), REPS))
    longdp = _gcups(LONG_B * LONG_LQ * LONG_LT,
                    cuda_ms(lambda: sw_score_cuda(ql, tl, no_n=True), REPS))
    return {
        "sw_plain_gcups": plain,
        "sw_cells_per_batch": cells,
        "sw_cuda_gcups": fast,
        "sw_cuda_nmasked_gcups": nmasked,
        "sw_gcups": max(fast, plain),
        "sw_longdp_gcups": longdp,
    }


def region_step_inputs(device) -> tuple:
    """bench.py's region-step inputs (seed 1) on ``device``."""
    rng = np.random.default_rng(1)
    arrays = (
        rng.integers(0, 4, size=(G, R, L)).astype(np.int8),
        np.full((G, R), L, dtype=np.int32),
        rng.integers(0, 4, size=(G, LREF)).astype(np.int8),
        np.full((G,), LREF, dtype=np.int32),
        rng.integers(0, 4, size=(G, GB, GLQ)).astype(np.int8),
        rng.integers(0, 4, size=(G, GB, GLT)).astype(np.int8),
    )
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def bench_region_step(device) -> dict:
    from breakmer_tpu_torch.parallel.step import make_region_step
    from breakmer_tpu_torch.timing import cuda_ms, device_us

    inputs = region_step_inputs(device)
    step = make_region_step(mesh=None, k=K)
    ms = cuda_ms(lambda: step(*inputs), REPS)
    return {
        # the region step alone (no host stages, no IO): not end-to-end
        # panel throughput
        "device_step_regions_per_s": G / ms * 1e3,
        "device_step_reads_per_s": G * R / ms * 1e3,
        "region_step_ms": ms,
        "region_step_device_ms": device_us(lambda: step(*inputs), REPS) / 1e3,
    }


def run(device) -> dict:
    """The bench's JSON object on ``device`` (a card)."""
    from breakmer_tpu_torch.timing import card_line

    sw = bench_sw(device)
    step = bench_region_step(device)
    return {
        "metric": "sw_wavefront_gcups",
        "value": sw["sw_gcups"],
        "unit": "GCUPS",
        "platform": "gpu",
        "device": torch.cuda.get_device_name(device),
        "card": card_line(),
        "detail": {**sw, **step},
    }


def main() -> None:
    from breakmer_tpu_torch.device import resolve

    print(json.dumps(run(resolve("cuda"))))


if __name__ == "__main__":
    main()
