"""The port's entry points (breakmer_tpu_torch.graft_entry) against the
repository's JAX entry file ``__graft_entry__.py`` on the CPU: the
example inputs bit for bit, ``entry()``'s step on its own arguments and on
planted inputs of the same shapes (tolerance 0, dtypes included), the
three-stage ``dryrun_multichip`` over a virtual mesh of CPU devices, and
the ``device.virtual_devices`` hook it runs the batched Runner under."""

import contextlib

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from breakmer_tpu_torch import device as tdevice
from breakmer_tpu_torch import graft_entry
from breakmer_tpu_torch.parallel.index_shard import make_shard_mesh
from breakmer_tpu_torch.parallel.mesh import make_mesh_2d
from breakmer_tpu_torch.parallel.step import to_numpy
from breakmer_tpu_torch.pipeline import TargetPipeline
from breakmer_tpu_torch.runner import Runner
from tests.test_torch_step import _inputs as planted_inputs

CPU = torch.device("cpu")
FIELDS = ("values", "counts", "scores", "q_end", "t_end")


def _dryrun_shape(n):
    G = B = max(8, n)
    return dict(G=G, R=8, L=32, Lref=128, B=B, Lq=16, Lt=32)


@pytest.mark.parametrize("kwargs", [
    {}, _dryrun_shape(2), _dryrun_shape(4), _dryrun_shape(8),
    {"seed": 0}, {"seed": 1}, {"seed": 5}, dict(_dryrun_shape(4), seed=5),
], ids=["defaults", "dryrun2", "dryrun4", "dryrun8", "seed0", "seed1", "seed5",
        "dryrun4_seed5"])
def test_example_inputs_equal_the_jax_entry_files(kwargs):
    want = graft._example_inputs(**kwargs)
    got = graft_entry._example_inputs(**kwargs)
    assert len(got) == len(want) == 6
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- entry()

_JAX = {}


def _jax_entry(name):
    """JAX ``entry()``'s fn on its example arguments ("example") or on
    planted inputs of the same shapes ("planted"), computed once."""
    if name not in _JAX:
        fn, args = graft.entry()
        if name == "planted":
            args = _planted()
        _JAX[name] = [np.asarray(x) for x in fn(*args)]
    return _JAX[name]


def _planted():
    return planted_inputs(15, G=4, R=64, L=128, Lref=2048, B=16, Lq=256, Lt=512)


@pytest.mark.parametrize("name", ["example", "planted"])
def test_entry_step_matches_jax_entry(name):
    fn, args = graft_entry.entry("cpu")
    assert all(a.device == CPU for a in args)
    if name == "planted":
        args = tuple(torch.from_numpy(a) for a in _planted())
    got = to_numpy(fn(*args))
    want = _jax_entry(name)
    for field, a, b in zip(FIELDS, want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    values, counts = got[:2]
    assert np.all((values == np.uint32(0xFFFFFFFF)) == (counts == 0))
    if name == "planted":  # the k-mer half is compared on kept k-mers too
        assert (counts >= 2).sum() > 0
    else:  # random reads: no k-mer reaches min_count
        assert (counts == 0).all()


def test_entry_defaults_to_the_card_and_never_falls_back(monkeypatch):
    asked = []
    monkeypatch.setattr(graft_entry, "resolve",
                        lambda device: asked.append(device) or CPU)
    graft_entry.entry()
    assert asked == ["cuda"]
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdevice.resolve("cuda").type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ((), ("cuda",), ("auto",)):
        with pytest.raises(RuntimeError, match="device=cpu"):
            graft_entry.entry(*device)


# ------------------------------------------------------- dryrun_multichip()

@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip_on_a_virtual_cpu_mesh(n):
    graft_entry.dryrun_multichip(n, devices=[CPU] * n)


def test_dryrun_multichip_takes_the_visible_cards_only(monkeypatch):
    with pytest.raises(RuntimeError, match="device=cpu"):
        graft_entry.dryrun_multichip(4)  # no card here: never the CPU quietly
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="n_devices=4: 2 devices available"):
        graft_entry.dryrun_multichip(4)
    with pytest.raises(ValueError, match="n_devices=4: 3 devices available"):
        graft_entry.dryrun_multichip(4, devices=[CPU] * 3)


def _drop_last_event(monkeypatch):
    orig = Runner._run_batched
    monkeypatch.setattr(Runner, "_run_batched", lambda self, resume: orig(self, resume)[:-1])


def _no_virtual_devices(monkeypatch):
    monkeypatch.setattr(graft_entry, "virtual_devices",
                        lambda devices: contextlib.nullcontext())


def _fail_reference_region(monkeypatch):
    orig = TargetPipeline.classify_contigs

    def classify(self, segs):
        if self.target.name == "DRY_REF":  # no call there: the rows still agree
            raise RuntimeError("planted fault")
        return orig(self, segs)

    monkeypatch.setattr(TargetPipeline, "classify_contigs", classify)


@pytest.mark.parametrize("fault,match", [
    (_drop_last_event, "diverge from serial"),
    (_no_virtual_devices, "not on 4 devices"),
    (_fail_reference_region, "region errors"),
], ids=["batched_calls_differ", "never_meshed", "region_error"])
def test_dryrun_full_panel_bites(fault, match, monkeypatch):
    fault(monkeypatch)
    with pytest.raises(AssertionError, match=match):
        graft_entry._dryrun_full_panel([CPU] * 4)


# ------------------------------------------------- device.virtual_devices

def test_virtual_devices_feed_the_meshes_and_restore(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tdevice.virtual_devices([CPU] * 4) as devs:
        assert devs == [CPU] * 4
        assert tdevice.local_devices() == tdevice.local_devices("cuda:3") == devs
        assert make_mesh_2d().devices.shape == (2, 2)
        assert make_shard_mesh().devices.shape == (4,)
        with tdevice.virtual_devices(["cpu"] * 2):  # nested: the inner one wins
            assert make_mesh_2d().devices.shape == (2, 1)
        assert make_mesh_2d().devices.shape == (2, 2)
    assert tdevice.local_devices("cpu") == [CPU]  # no leak
    with pytest.raises(RuntimeError, match="device=cpu"):
        make_mesh_2d()  # back to every visible card: none here


def test_virtual_devices_restore_after_an_exception():
    with pytest.raises(KeyError):
        with tdevice.virtual_devices([CPU] * 3):
            raise KeyError("inside")
    assert tdevice.local_devices("cpu") == [CPU]
    with pytest.raises(ValueError, match="no devices"):
        with tdevice.virtual_devices([]):
            pass
