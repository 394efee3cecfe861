"""The SW engine over its input domain on the CPU. On every case of
``breakmer_tpu_torch.testing.sw_domain`` (signed scoring parameters, each
at the old and new limits, crossed with the edges of the shapes and codes):
the port's plain ``sw_score`` gives the JAX scan's value or raises its
exception type; the card wrapper's admission (``sw_cuda.admit``, plain
Python) refuses exactly its documented set; and a numpy mirror of the
kernel's cell loop, run at the admission's pack and no_n on the caller's
parameters, gives the JAX scan's value. Under the parent's decisions the
mirror shows the two faults this domain found (a packed key that
overflows, a no_n byte table that wraps). The bound behind the pack is
held by a property test. Exact (tolerance 0: integer outputs). The same grid runs through the
kernel on a card in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
phase 23."""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from breakmer_tpu.ops import sw as jsw
from breakmer_tpu_torch.ops import sw_cuda
from breakmer_tpu_torch.ops.sw import NEG, SWParams, sw_score
from breakmer_tpu_torch.testing import sw_domain

CASES = sw_domain.cases()


@functools.lru_cache(maxsize=None)
def _jax(name):
    """(True, (score, q_end, t_end)) or (False, the exception's type)."""
    c = sw_domain.case(name)
    try:
        out = jsw.sw_score(jnp.asarray(c["q"]), jnp.asarray(c["t"]), jsw.SWParams(*c["params"]))
    except Exception as exc:  # the JAX package's failure is part of its contract
        return False, type(exc)
    return True, tuple(np.asarray(o) for o in out)


def _port(q, t, params):
    try:
        out = sw_score(torch.from_numpy(q), torch.from_numpy(t), params)
    except Exception as exc:  # the plain version's failure is part of its contract
        return False, type(exc)
    return True, tuple(o.numpy() for o in out)


def _same(want, got, what):
    assert want[0] == got[0], (what, want, got)
    if not want[0]:
        assert want[1] is got[1], (what, want[1], got[1])
        return
    for a, b in zip(want[1], got[1], strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), (what, a, b)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_over_the_domain(name):
    c = sw_domain.case(name)
    _same(_jax(name), _port(c["q"], c["t"], c["params"]), name)


# -- the wrapper's decision ------------------------------------------------

def _refused(B, Lq, Lt, p):
    """The documented refusals (``sw_cuda.admit``)."""
    i32 = range(-2**31, 2**31)
    return (Lq == 0 or any(x not in i32 for x in (*p, p.gap_open + p.gap_extend))
            or p.match * min(Lq, Lt) >= 2**28 or Lq + Lt >= 2**31 or Lt + 32 >= 2**31)


@pytest.mark.parametrize("name", CASES)
def test_admission_refuses_exactly_the_documented_set(name):
    """admit refuses where the documentation says, and nowhere else: not
    where the parent refused a parameter of 2^20 or more, gap_extend * Lt of
    2^26 or more, or Lt = 0. Where it admits: no launch at B = 0 or Lt = 0,
    the no_n form only under its conditions, and the pack only where the
    bound allows it."""
    c = sw_domain.case(name)
    p = c["params"]
    (B, Lq), Lt = c["q"].shape, c["t"].shape[1]
    if _refused(B, Lq, Lt, p):
        with pytest.raises(ValueError):
            sw_cuda.admit(B, Lq, Lt, p)
        return
    for no_n in (False, True):
        adm = sw_cuda.admit(B, Lq, Lt, p, no_n)
        assert sw_cuda.plain_in_int32(Lq, Lt, p)  # every case of the grid stays in int32
        assert adm.no_n == (no_n and p.mismatch > 0 and p.gap_extend > 0
                            and -128 <= p.match <= 127 and -128 <= -p.mismatch <= 127)
        assert (adm.plan is None) == (B == 0 or Lt == 0)
        if adm.plan is not None:
            U, go = sw_cuda.score_bound(Lq, Lt, p), abs(p.gap_open + p.gap_extend)
            assert adm.plan.pack == (U < 2**15 and Lt <= 2**16
                                     and U + go + abs(p.gap_extend) * (Lt + 32) < 2**31)
            assert not sw_cuda.admit(B, Lq, Lt, p, no_n, unpacked=True).plan.pack


@pytest.mark.parametrize("B,Lq,Lt,params,why", [
    (2, 0, 8, SWParams(), "a query of no base"),
    (0, 0, 0, SWParams(), "a query of no base"),
    (2, 8, 8, SWParams(2**31, 3, 5, 1), "match past int32"),
    (2, 8, 8, SWParams(2, -2**31 - 1, 5, 1), "mismatch past int32"),
    (2, 8, 8, SWParams(2, 3, 2**31 - 1, 1), "gap_open + gap_extend past int32"),
    (2, 8, 8, SWParams(2, 3, 5, -2**31 - 1), "gap_extend past int32"),
    (1, 2**14, 2**14, SWParams(2**14, 3, 5, 1), "the TPU kernel's score limit"),
    (0, 2**14, 2**14, SWParams(2**14, 3, 5, 1), "the TPU kernel's score limit, B = 0"),
    (1, 2**30, 2**30, SWParams(0, 3, 5, 1), "past the kernel's counters"),
    (1, 1, 2**31 - 32, SWParams(0, 3, 5, 1), "past the kernel's step counter"),
])
def test_admission_refuses_its_documented_set_past_the_grid(B, Lq, Lt, params, why):
    assert _refused(B, Lq, Lt, params)
    with pytest.raises(ValueError):
        sw_cuda.admit(B, Lq, Lt, params)


@pytest.mark.parametrize("B,Lq,Lt,params", [
    (2, 8, 8, SWParams(-2**30, 3, 5, 1)), (2, 8, 8, SWParams(2, 3, 2**31 - 2, 1)),
    (2, 8, 8, SWParams(2, 3, -2**31, 0)), (1, 2**14, 2**14, SWParams(2**14 - 1, 3, 5, 1)),
    (3, 64, 4096, SWParams(2, 3, 5, -10**6)), (3, 40, 70, SWParams(2, 2**30, 5, 2**29)),
    (1, 2**30 - 1, 2**30, SWParams(0, 3, 5, 1)),
])
def test_admission_takes_what_the_plain_version_answers_past_int32(B, Lq, Lt, params):
    """Where the plain version's values may leave int32 the card still runs
    (the unpacked form, which computes the plain version's own int32
    operations) instead of refusing."""
    adm = sw_cuda.admit(B, Lq, Lt, params, no_n=True)
    if not sw_cuda.plain_in_int32(Lq, Lt, params):
        assert not adm.no_n
        assert not adm.plan.pack


_PARENT_TIERS = {  # (form, R) of the parent's plan at each realign tier, Lq-major
    range(1, 13): "bbbbEbbbEbbbEEEE", range(13, 240): "TTTTEETTEEETEEEE"}
_PARENT_SHAPES = {  # chip_smoke.SW_SHAPES and SW_FORM_SHAPES: the parent's plans
    (512, 256, 512): "E", (301, 128, 256): "T", (37, 1024, 2048): "E", (16, 1024, 6144): "T",
    (8, 3072, 2048): "E", (64, 512, 16384): "T", (2, 10240, 2048): "E", (1, 256, 512): "b",
    (1, 256, 1024): "b", (12, 512, 1024): "b"}
_FORMS = {"b": ("block", 2), "T": ("ticket", 4), "E": ("ticket", 8)}


@pytest.mark.parametrize("B", [1, 2, 5, 12, 13, 25, 64, 239])
def test_default_launches_keep_the_parents_plan(B):
    """At the default parameters the plan (form, R, pack) is the parent's
    on every realign tier (Lq 128-1024 x Lt 256-2048), and on every shape
    of chip_smoke's SW_SHAPES and SW_FORM_SHAPES: all packed."""
    tiers = next(v for r, v in _PARENT_TIERS.items() if B in r)
    shapes = [(Lq, Lt) for Lq in (128, 256, 512, 1024) for Lt in (256, 512, 1024, 2048)]
    for (Lq, Lt), want in zip(shapes, tiers, strict=True):
        plan = sw_cuda.admit(B, Lq, Lt, SWParams(), True).plan
        assert (plan.form, plan.rows_per_lane, plan.pack) == (*_FORMS[want], True), (B, Lq, Lt)
    for shape, want in _PARENT_SHAPES.items():
        plan = sw_cuda.launch_plan(*shape)
        assert (plan.form, plan.rows_per_lane, plan.pack) == (*_FORMS[want], True), shape


# -- a numpy mirror of the kernel's cell loop --------------------------------

def _w(x):
    """int32 wrap of int64 values."""
    return ((np.asarray(x, np.int64) + 2**31) & 0xFFFFFFFF) - 2**31


def _no_n_sub(q, t, match, mismatch):
    """The no_n form's substitution: codes outside 0-3 re-encoded (query 6,
    target 7), a per-column table of 8 bytes (``nm4`` the bytes of
    -mismatch, byte tc of its low word XORed to match), the query code's
    byte read back sign-extended as ``prmt`` with selector nibbles 8 | c."""
    qc = np.where((q < 0) | (q >= 4), 6, q).astype(np.int64)
    tc = np.where((t < 0) | (t >= 4), 7, t).astype(np.int64)
    nm = (-mismatch) & 0xFF
    nm4 = nm * 0x01010101
    xm = (match ^ -mismatch) & 0xFF
    tlo = np.where(tc < 4, nm4 ^ (xm << (8 * np.minimum(tc, 3))), nm4).astype(np.uint64)
    word = tlo | np.uint64(nm4 << 32)  # bytes 0-3 of tlo, then 4-7 of thi
    byte = ((word >> (8 * qc).astype(np.uint64)) & np.uint64(0xFF)).astype(np.int64)
    return np.where(byte >= 128, byte - 256, byte)


def _mirror(q, t, params, pack, no_n, drift=None):
    """The kernel's outputs (score, q_end, t_end) from its cell loop in
    wrapping int32: ``pack`` a row's best as the key H * 2^16 + 65535 - j,
    else score and column apart; ``drift`` (default: ``pack``) E kept as E'
    = E + ge * j through __viaddmax_s32(H_left, ge j - go, E'_left) and
    read back with __viaddmax_s32(E', -ge j, F), else E = max(H_left - go,
    E_left - ge). Cells in anti-diagonal order, any order their
    dependences allow giving the same values."""
    drift = pack if drift is None else drift
    B, Lq = q.shape
    Lt = t.shape[1]
    m, mm, gap_open, ge = (int(x) for x in params)
    go = int(_w(gap_open + ge))
    qi, ti = q.astype(np.int64), t.astype(np.int64)
    H1 = np.zeros((B, Lq), np.int64)  # H of the last diagonal, by row i
    H2 = np.zeros((B, Lq), np.int64)
    E1 = np.full((B, Lq), NEG, np.int64)
    F1 = np.full((B, Lq), NEG, np.int64)
    key = np.zeros((B, Lq), np.int64)  # packed: the row's key; else its best
    bj = np.full((B, Lq), -1, np.int64)
    i = np.arange(Lq)
    for d in range(Lq + Lt - 1):
        j = d - i
        inside = (j >= 0) & (j < Lt)
        tj = np.where(inside, ti[:, np.clip(j, 0, Lt - 1)], 7)
        if no_n:
            sub = _no_n_sub(qi, tj, m, mm)
        else:
            sub = np.where(qi == tj, m, _w(-mm))
            sub = np.where((qi >= 4) | (tj >= 4), NEG, sub)
        hu = np.concatenate([np.full((B, 1), NEG), H1[:, :-1]], 1)  # (i - 1, j)
        fu = np.concatenate([np.full((B, 1), NEG), F1[:, :-1]], 1)
        dg = np.concatenate([np.zeros((B, 1), np.int64), H2[:, :-1]], 1)  # (i - 1, j - 1)
        dg = np.where(j == 0, 0, dg)
        f = np.maximum(_w(hu - go), _w(fu - ge))
        if drift:
            ea = np.where(j == 0, NEG, _w(_w(ge * j) - go))
            e = np.maximum(_w(H1 + ea), E1)
            h = np.maximum(np.maximum(_w(dg + sub), np.maximum(_w(e + _w(-ge * j)), f)), 0)
        else:
            e = np.where(j == 0, NEG, np.maximum(_w(H1 - go), _w(E1 - ge)))
            h = np.maximum(np.maximum(_w(dg + sub), np.maximum(e, f)), 0)
        h = np.where(inside, h, 0)
        e = np.where(inside, e, NEG)
        f = np.where(inside, f, NEG)
        if pack:
            key = np.where(inside, np.maximum(key, _w(_w(h * 65536) + 65535 - j)), key)
        else:
            up = inside & (h > key)
            bj = np.where(up, j, bj)
            key = np.where(up, h, key)
        H2, H1, E1, F1 = H1, h, e, f
    s = key >> 16 if pack else key
    jj = 65535 - (key & 65535) if pack else bj
    # the full key per pair: score desc, i + j asc, i asc
    order = np.lexsort((np.broadcast_to(i, (B, Lq)), i + jj, -s), axis=1) if Lq else None
    score = np.zeros(B, np.int32)
    q_end = np.full(B, -1, np.int32)
    t_end = np.full(B, -1, np.int32)
    for b in range(B):
        r = order[b, 0]
        if s[b, r] > 0:
            score[b], q_end[b], t_end[b] = s[b, r], r, jj[b, r]
    return score, q_end, t_end


def _mirror_at(c, no_n, B, Lq, Lt):
    adm = sw_cuda.admit(B, Lq, Lt, c["params"], no_n)
    if adm.plan is None:  # the wrapper's own answer, with no launch
        return True, (np.zeros(B, np.int32), np.full(B, -1, np.int32), np.full(B, -1, np.int32))
    return True, _mirror(c["q"], c["t"], c["params"], adm.plan.pack, adm.no_n)


@pytest.mark.parametrize("name", CASES)
def test_kernel_mirror_matches_jax_at_the_plans_decisions(name):
    """The mirror at the admission's pack and no_n (no_n asked
    for where the codes allow it), and forced unpacked, gives the JAX
    scan's value; where the admission refuses, the JAX scan answers only
    past the TPU kernel's score limit."""
    c = sw_domain.case(name)
    (B, Lq), Lt = c["q"].shape, c["t"].shape[1]
    want = _jax(name)
    try:
        sw_cuda.admit(B, Lq, Lt, c["params"])
    except ValueError:
        assert not want[0] or c["params"].match * min(Lq, Lt) >= 2**28, name
        return
    for no_n in (False, True) if c["no_n"] else (False,):
        _same(want, _mirror_at(c, no_n, B, Lq, Lt), f"{name} no_n={no_n}")
        if B and Lt:
            k = sw_cuda.admit(B, Lq, Lt, c["params"], no_n)
            _same(want, (True, _mirror(c["q"], c["t"], c["params"], False, k.no_n)),
                  f"{name} no_n={no_n} unpacked")


def _parent_mirror(c, no_n):
    """The kernel under the parent's decisions: pack where match * min(Lq,
    Lt) < 2^15 and Lt <= 2^16, E always drifted, no_n for match <= 127
    with no lower bound, the parameters as given."""
    p = c["params"]
    (B, Lq), Lt = c["q"].shape, c["t"].shape[1]
    pack = p.match * min(Lq, Lt) < 2**15 and Lt <= 2**16
    no_n = no_n and p.mismatch > 0 and p.gap_extend > 0 and p.match <= 127 and p.mismatch <= 128
    return _mirror(c["q"], c["t"], p, pack, no_n, drift=True)


@pytest.mark.parametrize("name,no_n,what", [
    ("mismatch_bonus_1000/pair_64x128", False, "the packed key overflows past 2^15"),
    ("match_-200/trailing_pad", True, "the no_n table's match byte wraps to 56"),
])
def test_kernel_mirror_shows_the_parents_faults(name, no_n, what):
    """Under the parent's decisions the mirror differs from JAX here; under
    this wrapper's it agrees (test_kernel_mirror_matches_jax_at_the_plans_decisions)."""
    c = sw_domain.case(name)
    want = _jax(name)
    got = _parent_mirror(c, no_n)
    assert not all(np.array_equal(a, b) for a, b in zip(want[1], got)), what
    (B, Lq), Lt = c["q"].shape, c["t"].shape[1]
    _same(want, _mirror_at(c, no_n, B, Lq, Lt), name)


def test_a_code_below_0_under_no_n_scores_as_a_pad():
    """The one deliberate divergence of the no_n form: a caller that asserts
    no_n for codes below 0 (which realign never does) gets them scored as
    pads, -mismatch against every code, where the plain version scores a
    match where two equal ones meet. The mirror's no_n answer is the JAX
    scan's on the codes with every one below 0 made a code that matches
    nothing, and it differs from the JAX scan on the codes themselves."""
    c = sw_domain.case("default/negative_codes")
    q, t = c["q"], c["t"]
    got = _mirror(q, t, c["params"], True, True)
    qa = np.where(q < 0, np.int8(-2), q)  # -2 never meets -3
    ta = np.where(t < 0, np.int8(-3), t)
    as_pads = [np.asarray(x) for x in jsw.sw_score(jnp.asarray(qa), jnp.asarray(ta))]
    _same((True, tuple(as_pads)), (True, got), "as pads")
    want = _jax("default/negative_codes")[1]
    assert not all(np.array_equal(a, b) for a, b in zip(want, got))


# -- the bound behind the pack ------------------------------------------------

_SIGNED = st.integers(-40, 40) | st.sampled_from([-5000, -1000, 1000, 5000, 10**6])


@settings(max_examples=120, deadline=None, derandomize=True)
@given(Lq=st.integers(1, 24), Lt=st.integers(1, 40), B=st.integers(1, 3),
       seed=st.integers(0, 2**16), params=st.tuples(_SIGNED, _SIGNED, _SIGNED, _SIGNED),
       n_rate=st.sampled_from([0.0, 0.1]))
def test_score_bound_holds_and_the_plans_pack_is_exact(Lq, Lt, B, seed, params, n_rate):
    """Over random small pairs and signed parameters: U bounds the plain
    best; where the plan packs, that best is below 2^15; and the mirror at
    the plan's pack gives the plain version's value."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.int8)
    t[:, : min(Lq, Lt) // 2] = q[:, : min(Lq, Lt) // 2]
    q[rng.random(q.shape) < n_rate] = 4
    p = SWParams(*params)
    want = _port(q, t, p)[1]
    adm = sw_cuda.admit(B, Lq, Lt, p)
    assert sw_cuda.plain_in_int32(Lq, Lt, p)
    assert sw_cuda.score_bound(Lq, Lt, p) >= int(want[0].max())
    if adm.plan.pack:
        assert int(want[0].max()) < 2**15
    for a, b in zip(want, _mirror(q, t, p, adm.plan.pack, False)):
        assert np.array_equal(a, b), (p, adm.plan.pack)


# -- cli run at penalties past the parent's limit ---------------------------

@pytest.mark.parametrize("batched", [False, True], ids=["serial", "batched"])
def test_cli_run_at_ungapped_penalties_matches_jax(batched, tmp_path):
    """``cli run`` on scenario seed 1 (two genes, a matched normal) at
    gap_open_pen = gap_extend_pen = 1,000,000 (no gap pays): the port's
    svs.out, VCF and ledger rows equal the JAX package's byte for byte,
    and neither run records a region error."""
    from breakmer_tpu.cli import main as jax_main
    from breakmer_tpu_torch.cli import main as port_main
    from tests.scenarios import build_scenario

    cfg_kwargs, _ = build_scenario(1, tmp_path, n_genes=2, kinds=["ins", "del"],
                                   with_normal_germline=True)
    cfg_kwargs.pop("reference_data_dir")  # each run builds its own index
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({**cfg_kwargs, "gap_open_pen": 1_000_000,
                                    "gap_extend_pen": 1_000_000, "batch_regions": batched,
                                    "device": "cpu", "log_level": "WARNING"}))
    out = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        adir = tmp_path / name
        assert main(["run", str(cfg_file), "--analysis-dir", str(adir)]) == 0
        ledger = json.loads((adir / "ledger.json").read_text())
        metrics = json.loads((adir / "metrics.json").read_text())
        assert metrics["errors"] == {} and metrics["targets"] == len(ledger) == 3, name
        out[name] = ((adir / "output" / "prop_svs.out").read_bytes(),
                     (adir / "output" / "prop.vcf").read_bytes(),
                     {n: (e["rows"], e["vcf"], e["error"]) for n, e in ledger.items()})
    assert out["port"] == out["jax"]
