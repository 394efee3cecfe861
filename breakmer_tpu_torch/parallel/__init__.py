"""Region parallelism. Ported so far: the fused region step on one
device (``parallel.step.make_region_step(mesh=None)``). The mesh, the
region batcher and the sharded forms are still to port (ROADMAP
Queue 1); nothing here imports them, so the package stays JAX-free."""

from breakmer_tpu_torch.parallel.step import make_region_step

__all__ = ["make_region_step"]
