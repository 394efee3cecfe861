"""The fused region step: breakmer_tpu_torch.parallel.step against
breakmer_tpu.parallel.step (unsharded, and sharded over a mesh of CPU
devices) on the same numpy inputs from a seed. Every output is an integer: tolerance 0, dtypes
included (k-mer values come back as uint32 with SENTINEL padding)."""

import numpy as np
import pytest
import torch

from breakmer_tpu.parallel.step import make_region_step as jax_region_step
from breakmer_tpu_torch.parallel.step import make_region_step, to_numpy


def _inputs(seed, G, R, L, Lref, B, Lq, Lt):
    """Per region a reference and reads tiled over a sample haplotype that
    carries a novel insertion (so sample-only k-mers occur at counts >= 2),
    with ragged read lengths and scattered N; SW pairs with planted copies
    and trailing pads."""
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 4, (G, Lref)).astype(np.int8)
    ref_lengths = rng.integers(Lref * 3 // 4, Lref + 1, G).astype(np.int32)
    reads = np.full((G, R, L), 4, np.int8)
    lengths = rng.integers(L // 2, L + 1, (G, R)).astype(np.int32)
    for g in range(G):
        at = int(rng.integers(0, Lref // 2))
        novel = rng.integers(0, 4, L).astype(np.int8)
        hap = np.concatenate([refs[g, :at], novel, refs[g, at:]])
        starts = rng.integers(max(0, at - L), at + L // 2, R)
        for r, s in enumerate(starts):
            reads[g, r, :lengths[g, r]] = hap[s:s + lengths[g, r]]
    reads[rng.random(reads.shape) < 0.005] = 4
    q = rng.integers(0, 4, (G, B, Lq)).astype(np.int8)
    t = rng.integers(0, 4, (G, B, Lt)).astype(np.int8)
    for g in range(G):
        for b in range(0, B, 2):
            n = Lq // 2
            s = int(rng.integers(0, Lt - n + 1))
            t[g, b, s:s + n] = q[g, b, :n]
    q[:, :, Lq - Lq // 8:] = 4
    return reads, lengths, refs, ref_lengths, q, t


@pytest.mark.parametrize("k,shape", [
    (9, dict(G=4, R=8, L=32, Lref=128, B=8, Lq=16, Lt=32)),
    (15, dict(G=3, R=48, L=100, Lref=600, B=6, Lq=64, Lt=160)),
])
def test_region_step_matches_jax(k, shape):
    inputs = _inputs(k, **shape)
    want = [np.asarray(x) for x in jax_region_step(mesh=None, k=k)(*inputs)]
    got = to_numpy(make_region_step(mesh=None, k=k)(*map(torch.from_numpy, inputs)))
    names = ("values", "counts", "scores", "q_end", "t_end")
    for name, a, b in zip(names, want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    values, counts = got[:2]
    assert (counts >= 2).sum() > 0  # sample-only k-mers survive the threshold
    assert np.all((values == np.uint32(0xFFFFFFFF)) == (counts == 0))
    assert (got[2] > 0).all()


def test_region_step_sharded_form_matches_jax():
    """The sharded step on a (2, 2) mesh of CPU devices against the JAX
    sharded step on a (2, 2) mesh of its virtual CPU devices."""
    from breakmer_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
    from breakmer_tpu_torch.parallel.mesh import make_mesh_2d

    inputs = _inputs(9, G=4, R=8, L=32, Lref=128, B=8, Lq=16, Lt=32)
    want = [np.asarray(x) for x in jax_region_step(mesh=jax_make_mesh_2d(4), k=9)(*inputs)]
    mesh = make_mesh_2d(devices=[torch.device("cpu")] * 4)
    assert mesh.devices.shape == (2, 2)
    got = to_numpy(make_region_step(mesh=mesh, k=9)(*map(torch.from_numpy, inputs)))
    for name, a, b in zip(("values", "counts", "scores", "q_end", "t_end"), want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
