"""Region parallelism: mesh setup, region batching, sharded device step.

Port of ``breakmer_tpu/parallel``. A mesh (``parallel.mesh``) is a numpy
array of torch devices over named axes:

  axis "regions": regions scattered across devices (the Pool analog)
  axis "pairs":   the (contig, window) SW batch within a region
  merge:          per-shard outputs gathered onto the mesh's first device

The sharded forms are ``make_region_step(mesh=...)``, the k-mer batch
step over the regions axis (``parallel.kmer_batch``) and the range-sharded
seed table (``parallel.index_shard``); ``parallel.multihost`` partitions
targets across processes.
"""

from breakmer_tpu_torch.parallel.mesh import make_mesh_2d, mesh_axes
from breakmer_tpu_torch.parallel.regions import RegionBatch, pack_region_batches
from breakmer_tpu_torch.parallel.step import make_region_step

__all__ = [
    "make_mesh_2d", "mesh_axes", "RegionBatch", "pack_region_batches",
    "make_region_step",
]
