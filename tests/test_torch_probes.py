"""The probes ported to the card (breakmer_tpu_torch.tools), on the CPU,
against the JAX probes of tools/: every probe module runs with
pl.pallas_call in interpret mode, and each body's output on the probe's
own inputs is held against the port's plain version on the same inputs.
All outputs are integers: tolerance 0, dtypes included. Also the bench's
shapes against bench.py's, and the refusal of every wrapper and entry
point to run off a card."""

import ast
import contextlib
import io
import runpy
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from breakmer_tpu_torch.tools import probe_mosaic_cummax as cm
from breakmer_tpu_torch.tools import probe_swar_i16 as i16
from breakmer_tpu_torch.tools import probe_swar_i16b as i16b
from breakmer_tpu_torch.tools import sw_ceiling_probe as ceil

REPO = Path(__file__).resolve().parent.parent
_PALLAS_CALL = pl.pallas_call
_RUNS = {}


def _jax_probe(path):
    """Run a JAX probe module with every pallas_call in interpret mode:
    (its globals, [(kernel, inputs, output)] per call in order, stdout)."""
    if path not in _RUNS:
        calls = []

        def interpret(kernel, **kw):
            fn = _PALLAS_CALL(kernel, interpret=True, **kw)

            def call(*args):
                out = fn(*args)
                calls.append((kernel, [np.array(a) for a in args], np.asarray(out)))
                return out
            return call

        out = io.StringIO()
        with mock.patch.object(pl, "pallas_call", interpret), \
                contextlib.redirect_stdout(out):
            g = runpy.run_path(str(REPO / path))
        _RUNS[path] = (g, calls, out.getvalue())
    return _RUNS[path]


def _assert_same(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# numpy expectations of the lambda-only bodies, as the probes state them
_NP_EXPECT = {
    "i16 maximum": lambda a, b: np.maximum(a, b),
    "i16 minimum": lambda a, b: np.minimum(a, b),
    "i16 add": lambda a, b: (a + b).astype(np.int16),
    "i16 sub const": lambda a: (a - 6).astype(np.int16),
    "i16 mul": lambda a, b: (a.astype(np.int32) * b.astype(np.int32)).astype(np.int16),
    "i16 and/or/xor/not": lambda a, b, m: ((a & ~m) | (b & m)).astype(np.int16),
    "i32->i16 astype": lambda a: a.astype(np.int16),
    "i16->i32 astype": lambda a: a.astype(np.int32),
    "i16 compare-select": lambda a, b: np.maximum(a, b),
    "i16 roll (lanes)": lambda a: np.roll(a, 1, axis=1),
    "i16 sub tensor": lambda a, b: (a - b).astype(np.int16),
    "i16 ashr 15": lambda a: (a >> 15).astype(np.int16),
    "i16 shl 1": lambda a: (a << 1).astype(np.int16),
    "i16 add splat-int16": lambda a: (a + 6).astype(np.int16),
    "i16 add py-int": lambda a: (a + 6).astype(np.int16),
    "i16 add full-array const": lambda a: (a + 6).astype(np.int16),
    "i16 emulated max": lambda a, b: np.maximum(a, b),
}
_NAMED = {  # op name -> the JAX probe's named body
    "indicator-select (bd update)": "k_indicator",
    "onehot shift-right select": "k_onehot",
    "fused mini-recurrence": "k_mini",
    "fused mini (emulated max)": "k_mini",
    "emulated strict-greater select": "k_upd",
}
_I16_CASES = [(mod, path, n) for mod, path in ((i16, "tools/probe_swar_i16.py"),
                                               (i16b, "tools/probe_swar_i16b.py"))
              for n in range(len(mod.OPS))]


@pytest.mark.parametrize("mod,path,n", _I16_CASES,
                         ids=[f"{m.__name__.rsplit('.', 1)[1]}-{m.OPS[n].name}"
                              for m, _, n in _I16_CASES])
def test_i16_op_matches_jax_body(mod, path, n):
    g, calls, stdout = _jax_probe(path)
    assert len(calls) == len(mod.OPS)
    assert stdout.count("bit-exact=True") == len(mod.OPS)  # body == numpy, in the probe
    op = mod.OPS[n]
    kernel, args, want = calls[n]
    if op.name in _NAMED:
        assert kernel is g[_NAMED[op.name]]
    ours = mod.inputs()
    for name, arr in zip(op.args, args):  # the port's inputs are the probe's
        np.testing.assert_array_equal(ours[name], arr)
    _assert_same(mod.run_op(op, *map(torch.from_numpy, args)), want)
    if op.name in _NP_EXPECT:
        np.testing.assert_array_equal(want, _NP_EXPECT[op.name](*args))


@pytest.mark.parametrize("mod,path,names", [
    (i16, "tools/probe_swar_i16.py", ("A", "B", "M", "H", "BH", "BD", "Q32", "T32")),
    (i16b, "tools/probe_swar_i16b.py", ("A", "B", "Q32", "T32", "H", "BH", "BD")),
])
def test_i16_probe_inputs_are_the_jax_probes(mod, path, names):
    g, _, _ = _jax_probe(path)
    ours = mod.inputs()
    for name in names:
        assert ours[name].dtype == g[name].dtype
        np.testing.assert_array_equal(ours[name], g[name])
    assert mod.SHAPE == g["SHAPE"]


def test_i16_op_ids_are_the_kernels_enum():
    src = (REPO / "breakmer_tpu_torch/csrc/probe_i16.cu").read_text()
    body = src[src.index("enum Op {") + len("enum Op {"):src.index("N_OPS")]
    enum = [w.strip() for line in body.splitlines()
            for w in line.split("//")[0].split(",") if w.strip()]
    assert [op.op_id for op in i16.OPS + i16b.OPS] == list(range(len(enum))) == \
        list(range(22))


@pytest.mark.parametrize("n", [0, 1])
def test_cummax_matches_jax_body(n):
    _, calls, stdout = _jax_probe("tools/probe_mosaic_cummax.py")
    assert len(calls) == 2 and stdout.count("correct: True") == 2
    (x,), want = calls[n][1], calls[n][2]
    np.testing.assert_array_equal(cm.inputs(), x)
    _assert_same(cm.cummax(torch.from_numpy(x)), want)


@pytest.mark.parametrize("do_rolls", [True, False])
def test_stripped_matches_jax_loop_kernel(do_rolls):
    g, _, _ = _jax_probe("tools/sw_ceiling_probe.py")
    assert (ceil.B, ceil.LQ, ceil.LT, ceil.U) == (g["B"], g["LQ"], g["LT"], g["U"])
    q, t = ceil.inputs("cpu")
    with mock.patch.object(pl, "pallas_call",
                           lambda k, **kw: _PALLAS_CALL(k, interpret=True, **kw)):
        want = np.asarray(g["stripped"](q.numpy(), t.numpy(), do_rolls))
    _assert_same(ceil.stripped(q, t, do_rolls), want)


def _np_loop(q, t, do_rolls, steps):
    """The probe's loop in numpy, with np.roll for the lane rolls."""
    hd1 = q.astype(np.int32)
    hd2 = np.zeros_like(hd1)
    fd1 = np.zeros_like(hd1)
    tj = t[:, :q.shape[1]].astype(np.int32)
    for _ in range(steps):
        if do_rolls:
            a, b, c = (np.roll(x, 1, axis=1) for x in (hd2, fd1, tj))
        else:
            a, b, c = np.maximum(hd2, 1), np.maximum(fd1, 2), np.maximum(tj, 3)
        hd2, hd1, fd1, tj = hd1, np.maximum(np.maximum(a, b), np.maximum(c, hd1)), b, c
    return hd1


@pytest.mark.parametrize("do_rolls", [True, False])
@pytest.mark.parametrize("steps", [0, 1, 2, 7, 100, 255])
def test_stripped_before_saturation_matches_numpy_roll(do_rolls, steps):
    rng = np.random.default_rng(steps)
    q = rng.integers(-100, 100, (8, ceil.LQ)).astype(np.int8)
    t = rng.integers(-100, 100, (8, ceil.LT)).astype(np.int8)
    want = _np_loop(q, t, do_rolls, steps)
    got = ceil.stripped(torch.from_numpy(q), torch.from_numpy(t), do_rolls, steps)
    _assert_same(got, want)
    if steps < ceil.LQ:  # not yet saturated: rows are not constant
        assert (want != want.max(axis=1, keepdims=True)).any()


def test_stripped_default_steps_is_the_probes():
    assert ceil.default_steps(ceil.LQ, ceil.LT) == 768
    assert ceil.default_steps(5, 4) == 8


def _assignments(tree, func):
    """Names bound to literal tuples/ints in function ``func`` of ``tree``."""
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    out = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Tuple) \
                and isinstance(node.value, ast.Tuple):
            names = [e.id for e in node.targets[0].elts]
            out.update(zip(names, ast.literal_eval(node.value)))
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "make_region_step":
            out.update({kw.arg: ast.literal_eval(kw.value) for kw in node.keywords
                        if kw.arg == "k"})
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "default_rng":
            out["seed"] = ast.literal_eval(node.args[0])
    return out


def test_bench_shapes_are_bench_py():
    from breakmer_tpu_torch import bench

    tree = ast.parse((REPO / "bench.py").read_text())
    top = {t.id: v for node in tree.body if isinstance(node, ast.Assign)
           and isinstance(node.targets[0], ast.Tuple)
           for t, v in zip(node.targets[0].elts, ast.literal_eval(node.value))}
    assert (bench.B, bench.LQ, bench.LT) == (top["B"], top["LQ"], top["LT"])
    sw = _assignments(tree, "bench_sw")
    assert (bench.LONG_B, bench.LONG_LQ, bench.LONG_LT) == (sw["Bl"], sw["Lql"], sw["Ltl"])
    assert sw["seed"] == 0
    step = _assignments(tree, "bench_region_step")
    assert (bench.G, bench.R, bench.L, bench.LREF, bench.GB, bench.GLQ, bench.GLT, bench.K) \
        == tuple(step[n] for n in ("G", "R", "L", "LREF", "GB", "GLQ", "GLT", "k"))
    assert step["seed"] == 1
    shapes = [tuple(x.shape) for x in bench.region_step_inputs("cpu")]
    assert shapes == [(8, 256, 128), (8, 256), (8, 4096), (8,), (8, 16, 256), (8, 16, 512)]


@pytest.mark.parametrize("entry", [
    "breakmer_tpu_torch.bench", "breakmer_tpu_torch.tools.sw_ceiling_probe",
    "breakmer_tpu_torch.tools.probe_swar_i16", "breakmer_tpu_torch.tools.probe_swar_i16b",
    "breakmer_tpu_torch.tools.probe_mosaic_cummax",
])
def test_measurement_entry_points_raise_without_a_card(entry, monkeypatch):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(entry).main()


def test_wrappers_refuse_a_non_cpu_non_cuda_tensor():
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        ceil.stripped(meta((4, 8), torch.int8), meta((4, 8), torch.int8), True)
    with pytest.raises(ValueError, match="meta"):
        cm.cummax(meta((4, 8), torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        i16.run_op(i16.OPS[0], meta((16, 256), torch.int16), meta((16, 256), torch.int16))
    with pytest.raises(ValueError, match="CUDA"):
        i16b.run_op(i16b.OPS[0], meta((16, 256), torch.int16), meta((16, 256), torch.int16))


def test_device_ns_counts_every_device_activity():
    """``timing.device_us`` sums the device activities of the trace: a
    kernel with no torch op above it (a ctypes launch) counts as much as
    one a torch op launched; host events count nothing."""
    from torch.autograd import DeviceType

    from breakmer_tpu_torch.timing import device_ns

    class Event:
        def __init__(self, device_type, start, end):
            self._t = (device_type, start, end)

        def device_type(self):
            return self._t[0]

        def start_ns(self):
            return self._t[1]

        def end_ns(self):
            return self._t[2]

    events = [Event(DeviceType.CPU, 0, 10_000),       # a torch op on the host
              Event(DeviceType.CUDA, 100, 1_300),     # its kernel
              Event(DeviceType.CPU, 20_000, 20_500),  # cudaLaunchKernel from ctypes
              Event(DeviceType.CUDA, 21_000, 101_000)]  # a kernel no torch op launched
    assert device_ns(events) == 1_200 + 80_000
    assert device_ns([]) == 0


# -- the warp layout of the probe kernels (one warp a row, lanes in
# -- registers, a lane roll as an in-thread shift plus one shuffle) ---------

from breakmer_tpu_torch import _build  # noqa: E402
from breakmer_tpu_torch.tools import warp_layout  # noqa: E402

_KERNELS = {"ceiling": ceil, "i16": i16}
_MAX_WIDTH = {"ceiling": 512, "i16": 1024}
_ROLL_CASES = [(k, w) for k in _KERNELS for w in (1, 2, 31, 32, 33, 255, 256, 300, 512, 1024)
               if w <= _MAX_WIDTH[k]]


def _warp_roll(x: np.ndarray, lay: warp_layout.Layout, pad: int) -> np.ndarray:
    """The kernels' roll of [rows, W] in numpy: a row as 32 threads of
    ``per_thread`` lanes (lanes past W hold ``pad``), each thread shifts
    its lanes by one and takes its lane 0 from the thread before, thread 0
    from the holder's ``last`` element (a rotate across the 32 threads)."""
    rows, W = x.shape
    n = lay.per_thread
    v = np.full((rows, warp_layout.WARP * n), pad, x.dtype)
    v[:, :W] = x
    v = v.reshape(rows, warp_layout.WARP, n)
    out = np.empty_like(v)
    out[:, :, 1:] = v[:, :, :-1]
    send = v[:, :, n - 1].copy()
    send[:, lay.holder] = v[:, lay.holder, lay.last]
    out[:, :, 0] = send[:, [lay.holder] + list(range(warp_layout.WARP - 1))]
    return out.reshape(rows, -1)[:, :W]


@pytest.mark.parametrize("kernel,width", _ROLL_CASES)
def test_warp_roll_matches_torch_roll(kernel, width):
    """The layout's roll (and the source of each lane) equals
    torch.roll(x, 1, 1); a lane past the width never feeds it."""
    lay = _KERNELS[kernel].plan(width)
    assert lay.per_thread in (ceil.R_CHOICES if kernel == "ceiling" else i16.RW_CHOICES)
    assert warp_layout.WARP * (lay.per_thread // 2) < width <= warp_layout.WARP * lay.per_thread
    x = np.random.default_rng(width).integers(-2**15, 2**15, (3, width)).astype(np.int16)
    want = torch.roll(torch.from_numpy(x), 1, 1).numpy()
    for pad in (0, 12345):
        np.testing.assert_array_equal(_warp_roll(x, lay, pad), want)
    src = warp_layout.roll_sources(lay)
    assert [t * lay.per_thread + k for t, k in src] == [(i - 1) % width for i in range(width)]
    assert all(0 <= t < warp_layout.WARP and 0 <= k < lay.per_thread for t, k in src)


@pytest.mark.parametrize("kernel,width", [("ceiling", 0), ("ceiling", 513), ("ceiling", 1024),
                                          ("i16", 0), ("i16", 1025)])
def test_plan_refuses_widths_out_of_range(kernel, width):
    with pytest.raises(ValueError, match="lanes"):
        _KERNELS[kernel].plan(width)


@pytest.mark.parametrize("kernel,width,per_thread", [
    ("ceiling", 1, 1), ("ceiling", 33, 2), ("ceiling", 256, 8), ("ceiling", 300, 16),
    ("ceiling", 512, 16), ("i16", 1, 1), ("i16", 33, 2), ("i16", 256, 8), ("i16", 544, 32),
    ("i16", 1024, 32),
])
def test_plan_lanes_a_thread(kernel, width, per_thread):
    lay = _KERNELS[kernel].plan(width)
    assert lay.per_thread == per_thread
    assert (lay.holder, lay.last) == divmod(width - 1, per_thread)


def test_plan_is_fixed_for_the_probes_shapes():
    """R = 8 at the ceiling probe's Lq = 256, the SW kernel's own rows a
    lane at the probe's shape; RW = 8 at the int16 probes' W = 256."""
    from breakmer_tpu_torch.ops import sw_cuda

    assert ceil.plan(ceil.LQ) == (256, 8, 31, 7)
    assert sw_cuda.launch_plan(ceil.B, ceil.LQ, ceil.LT, sms=132).rows_per_lane == 8
    assert i16.plan(i16.SHAPE[1]) == (256, 8, 31, 7) and i16b.SHAPE == i16.SHAPE


@pytest.mark.parametrize("source,choices", [("sw_ceiling_probe.cu", ceil.R_CHOICES),
                                            ("probe_i16.cu", i16.RW_CHOICES),
                                            ("probe_cummax.cu", cm.P_CHOICES)])
def test_kernel_instantiations_are_the_plans_choices(source, choices):
    """The extern "C" launcher instantiates exactly the template
    constants the layout picks from, and neither kernel uses shared
    memory or a barrier."""
    import re

    src = (REPO / "breakmer_tpu_torch/csrc" / source).read_text()
    entry = src[src.index('extern "C"'):]
    assert tuple(int(n) for n in re.findall(r"launch<(\d+)>", entry)) == choices
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "__syncthreads" not in code and "__shared__" not in code


@pytest.mark.parametrize("current", [0, 1])
def test_lean_launch_makes_the_card_current_only_when_needed(current, monkeypatch):
    """``_build.launch`` passes the raw current stream of the tensor's
    card as the last argument, enters the device context only for a card
    that is not current, and reports an error code only when it is not 0."""
    entered, errors, calls = [], [], []

    @contextlib.contextmanager
    def device(index):
        entered.append(index)
        yield

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: current, raising=False)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i,
                        raising=False)
    monkeypatch.setattr(_build, "check_launch", lambda err, what: errors.append((err, what)))
    for rc in (0, 7):
        _build.launch(lambda *a: calls.append(a) or rc, 1, "probe", 5, None)
    assert calls == [(5, None, 1001)] * 2
    assert entered == ([] if current == 1 else [1, 1])
    assert errors == [(7, "probe")]


def test_lean_launch_names_a_failed_launch_only_when_it_fails(monkeypatch):
    """A ``what`` given as a function is called only for a launch that
    returned an error, and its string is the one the error carries."""
    named, errors = [], []
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i,
                        raising=False)
    monkeypatch.setattr(_build, "check_launch", lambda err, what: errors.append((err, what)))
    for rc in (0, 0, 9):
        _build.launch(lambda *a: rc, 0, lambda: named.append(rc) or "sw_wavefront (B=2)")
    assert named == [9] and errors == [(9, "sw_wavefront (B=2)")]


@pytest.mark.parametrize("module", ["breakmer_tpu_torch/ops/sw_cuda.py",
                                    "breakmer_tpu_torch/ops/kmer_cuda.py",
                                    "breakmer_tpu_torch/tools/probe_mosaic_cummax.py",
                                    "breakmer_tpu_torch/tools/probe_swar_i16.py",
                                    "breakmer_tpu_torch/tools/sw_ceiling_probe.py"])
def test_kernel_wrappers_take_the_lean_launch_path(module):
    """Every kernel wrapper launches through ``_build.launch`` with the
    library's function kept in a module global: no ``torch.cuda.device``
    context, no ``Stream`` object, no ``check_launch`` of its own."""
    tree = ast.parse((REPO / module).read_text())
    names = {ast.unparse(n) for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert "_build.launch" in names
    assert not names & {"torch.cuda.device", "torch.cuda.current_stream", "_build.stream_of",
                        "_build.check_launch"}
    assert any(isinstance(n, ast.Assign) and [ast.unparse(t) for t in n.targets] == ["_LAUNCH"]
               for n in tree.body)


# -- the running-max kernel's scan in its layout (one warp a row, P lanes
# -- a thread in registers, a warp scan of the thread totals) --------------

_INT_MIN = np.iinfo(np.int32).min
_CUMMAX_WIDTHS = [1, 2, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257, 511, 512, 513,
                  1000, 1024]


def _warp_cummax(x: np.ndarray, per_thread: int, pad: np.ndarray) -> np.ndarray:
    """``csrc/probe_cummax.cu``'s scan of [rows, W] int32 in numpy: each
    of 32 threads holds ``per_thread`` lanes (lanes past W hold ``pad``,
    [rows, 32 * per_thread]), runs a running max over them; a
    Hillis-Steele scan of the 32 thread totals (``__shfl_up_sync`` by 1,
    2, 4, 8, 16: a thread below the offset keeps its own value); the
    exclusive carry is the scanned total of the thread before (thread 0:
    INT_MIN), and each lane takes the max of it and its own value."""
    rows, W = x.shape
    n, warp = per_thread, warp_layout.WARP
    v = pad.astype(np.int32).copy()
    v[:, :W] = x
    v = v.reshape(rows, warp, n)
    for k in range(1, n):
        v[:, :, k] = np.maximum(v[:, :, k], v[:, :, k - 1])
    lane = np.arange(warp)
    t = v[:, :, n - 1].copy()
    for off in (1, 2, 4, 8, 16):
        y = t[:, np.where(lane >= off, lane - off, lane)]
        t = np.where(lane >= off, np.maximum(t, y), t)
    carry = np.where(lane == 0, _INT_MIN, t[:, np.maximum(lane - 1, 0)])
    v = np.maximum(v, carry[:, :, None])
    return v.reshape(rows, -1)[:, :W]


def _rot(per_thread: int) -> np.ndarray:
    """The 16-byte chunk of the row that each thread takes at access 0 of
    the kernel's 16-byte path: the lane rotated left by log2(P) - 2 bits
    within 5 (access j adds 32 j)."""
    S, lane = per_thread.bit_length() - 3, np.arange(warp_layout.WARP)
    return ((lane << S) | (lane >> (5 - S))) & 31


def _load_coalesced(row: np.ndarray, per_thread: int) -> np.ndarray:
    """[32, P] registers of a warp after its 16-byte loads: access j of
    thread l fills registers 4 j .. 4 j + 3 with chunk 32 j + rot(l)."""
    chunks = row.reshape(-1, 4)
    return np.stack([chunks[32 * np.arange(per_thread // 4) + r].reshape(-1)
                     for r in _rot(per_thread)])


def _stages(v: np.ndarray, per_thread: int) -> np.ndarray:
    """The kernel's exchange in numpy: stage b swaps bit b of the chunk
    index with lane bit 5 - S + b (``__shfl_xor_sync`` on that mask; a
    thread whose lane bit is set keeps the chunks whose bit b is set and
    sends the others)."""
    S, lane = per_thread.bit_length() - 3, np.arange(warp_layout.WARP)
    for b in range(S):
        mask = 1 << (5 - S + b)
        hi = ((lane & mask) > 0)[:, None]
        new = v.copy()
        for i in range(per_thread // 4):
            if i & (1 << b):
                continue
            r0 = slice(4 * i, 4 * i + 4)
            r1 = slice(4 * (i | 1 << b), 4 * (i | 1 << b) + 4)
            got = np.where(hi, v[:, r0], v[:, r1])[lane ^ mask]
            new[:, r0] = np.where(hi, got, v[:, r0])
            new[:, r1] = np.where(hi, v[:, r1], got)
        v = new
    return v


@pytest.mark.parametrize("per_thread", [p for p in cm.P_CHOICES if p >= 4])
def test_coalesced_loads_and_exchange_give_the_layout(per_thread):
    """Each warp access of the 16-byte path covers 512 contiguous bytes;
    the exchange brings the loaded row into the layout (thread l holds
    lanes l*P .. l*P+P-1), and run on the layout it gives back the order
    the stores write, so each chunk goes back where it was read."""
    assert sorted(_rot(per_thread)) == list(range(warp_layout.WARP))
    row = np.arange(warp_layout.WARP * per_thread)
    layout = row.reshape(warp_layout.WARP, per_thread)
    np.testing.assert_array_equal(_stages(_load_coalesced(row, per_thread), per_thread),
                                  layout)
    np.testing.assert_array_equal(_stages(layout, per_thread),
                                  _load_coalesced(row, per_thread))


@pytest.mark.parametrize("width", _CUMMAX_WIDTHS)
def test_warp_cummax_matches_numpy(width):
    """The kernel's scan in its layout equals np.maximum.accumulate on
    full-range int32 (extremes included), with lanes past W at INT_MIN,
    as the kernel pads them, and at garbage: a lane past W never feeds a
    lane below it."""
    P = cm.plan(1, width).per_thread
    rng = np.random.default_rng(width)
    x = rng.integers(-2**31, 2**31, (5, width), dtype=np.int64).astype(np.int32)
    x[1] = _INT_MIN
    x[2] = np.iinfo(np.int32).max
    x[3, ::7] = _INT_MIN
    x[4] = np.arange(width)[::-1]  # falling: every lane keeps lane 0
    want = np.maximum.accumulate(x, axis=1)
    full = (5, warp_layout.WARP * P)
    for pad in (np.full(full, _INT_MIN),
                rng.integers(-2**31, 2**31, full, dtype=np.int64),
                np.full(full, np.iinfo(np.int32).max)):
        np.testing.assert_array_equal(_warp_cummax(x, P, pad), want)
    np.testing.assert_array_equal(cm.cummax(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("width", _CUMMAX_WIDTHS)
def test_cummax_plan_at_the_layouts_widths(width):
    """P is the warp layout's (the smallest power of two with 32 P >= W);
    a few rows take one warp a block."""
    for R in (1, 3, 8):
        p = cm.plan(R, width)
        assert p.per_thread in cm.P_CHOICES
        assert warp_layout.WARP * (p.per_thread // 2) < width <= warp_layout.WARP * p.per_thread
        assert p.per_thread == warp_layout.layout(width, cm.P_CHOICES).per_thread
        assert p.warps == 1


@pytest.mark.parametrize("R,warps", [(1, 1), (132, 1), (262, 1), (263, 2), (527, 4),
                                     (1056, 8), (16384, 8), (65536, 8)])
def test_cummax_plan_warps_a_block(R, warps):
    """The most warps a block (up to 8) that leave a block for each of the
    132 SMs."""
    p = cm.plan(R, 256)
    assert p.warps == warps <= cm.MAX_WARPS
    assert -(-R // warps) >= min(R, cm.SMS)
    assert warps == cm.MAX_WARPS or -(-R // (2 * warps)) < cm.SMS


@pytest.mark.parametrize("R,width", [(1, 0), (8, 1025), (0, 256)])
def test_cummax_plan_refuses(R, width):
    with pytest.raises(ValueError, match="lanes|rows"):
        cm.plan(R, width)
