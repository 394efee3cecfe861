"""breakmer_tpu_torch — the PyTorch/CUDA port of breakmer_tpu.

A structural-variant caller of the ``ccgd-profile/BreaKmer`` kind
(Abo et al., NAR 2015), ported from JAX on a TPU to PyTorch on an NVIDIA
Hopper card. ``breakmer_tpu`` stays beside it as the reference; every
module here mirrors the module of the same name there and is tested
against it. This package imports ``torch`` and never ``jax``, and no
module of ``breakmer_tpu`` either: the leaf modules it needs (``config``,
``encode``, ``native``, ``io/``, ``utils/``) are copies here that differ
from their originals only in their imports.

Layer map:
  config, encode, native, io/, utils/
             copies of the JAX package's leaf modules (configuration,
             base codes, the C++ library's bindings, file formats, meter)
  testing/   copies of the test fixtures and the planted-SV scenario
             generator, for chip_smoke.py and the panel bench
  ops/       k-mer engine (torch ops), Smith-Waterman (plain torch version
             and the hand-written CUDA kernel in csrc/)
  parallel/  the fused region step (k-mer subtraction + SW), one device
  bench      the benchmark: SW GCUPS, region-step regions/s, on the card
  tools/     the TPU probes ported to the card, each with a CUDA kernel
  timing     CUDA-event and profiler timing, the card's name and power
  assemble/  greedy k-mer-extension contig assembly (host)
  align/     seed index + seed-and-extend realignment + host traceback
  call/      breakpoint classification, support counting, filter stack
  pipeline   per-region pipeline
  runner     orchestrator (serial and batched paths)
  cli        entry point: python -m breakmer_tpu_torch.cli run <config>
"""

__version__ = "0.1.0"
