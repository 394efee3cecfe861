"""breakmer_tpu_torch — the PyTorch/CUDA port of breakmer_tpu.

A structural-variant caller of the ``ccgd-profile/BreaKmer`` kind
(Abo et al., NAR 2015), ported from JAX on a TPU to PyTorch on an NVIDIA
Hopper card. ``breakmer_tpu`` stays beside it as the reference; every
module here mirrors the module of the same name there and is tested
against it. This package imports ``torch`` and never ``jax``: it uses
only the JAX-free leaf modules of ``breakmer_tpu`` (``encode``,
``config``, ``io``, ``native``, ``utils``) and copies the host modules
that reach JAX through a package ``__init__``.

Layer map:
  ops/       k-mer engine (torch ops), Smith-Waterman (plain torch version
             and the hand-written CUDA kernel in csrc/)
  assemble/  greedy k-mer-extension contig assembly (host)
  align/     seed index + seed-and-extend realignment + host traceback
  call/      breakpoint classification, support counting, filter stack
  pipeline   per-region pipeline
  runner     orchestrator (serial path)
  cli        entry point: python -m breakmer_tpu_torch.cli run <config>
"""

__version__ = "0.1.0"
