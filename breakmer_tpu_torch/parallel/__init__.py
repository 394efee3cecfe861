"""Region parallelism on one device. Ported: the region batcher
(``parallel.regions``), the batched k-mer step (``parallel.kmer_batch``)
and the fused region step (``parallel.step.make_region_step(mesh=None)``).
The mesh and the sharded forms are still to port (ROADMAP Queue 1,
item 2); nothing here imports them, so the package stays JAX-free."""

from breakmer_tpu_torch.parallel.regions import RegionBatch, pack_region_batches
from breakmer_tpu_torch.parallel.step import make_region_step

__all__ = ["RegionBatch", "pack_region_batches", "make_region_step"]
