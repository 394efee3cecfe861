"""The SW engine's input domain as a grid of named cases, for holding the
port's plain ``sw_score`` to the JAX package on the CPU and the card's
kernel (``ops/sw_cuda.py``) to the plain version.

Each case is one parameter set of ``PARAMS`` (match, mismatch, gap_open,
gap_extend: the default and the usual others; match 0, all 0, gaps of 0;
mismatch and gap bonuses; negative and large matches, mismatch 128 and
129; penalties that forbid; each parameter at 2^20 - 1 and 2^20, once the
kernel's limit; gap_extend * Lt on either side of 2^26; match * min(Lq,
Lt) at 2^28 - 1 and 2^28, where the TPU kernel refuses) crossed with one
input variant of ``VARIANTS`` (B = 0; 1 x 1; Lq or Lt of 1; Lt = 0 and Lq
= 0; each rows-a-lane's strip edge 32 R - 1, 32 R, 32 R + 1; a pair of 64
x 128; codes with N mid-sequence, trailing pads, codes 5-127, codes below
0, all N, planted ties). Every parameter set meets the ``CORE_VARIANTS``
and every variant the ``CORE_PARAMS``. ``cases(card=True)`` adds the
``WIDE`` cases, too wide for the CPU: Lt of 2^16 and 2^16 + 1 (the packed
key's edge), the packed form's headroom either side of int32 there, and
queries of 2,049 and 10,240 rows. Inputs are made with numpy from the
case's seed.
"""

from __future__ import annotations

import numpy as np

from breakmer_tpu_torch.ops.sw import SWParams


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


PARAMS = {
    "default": (2, 3, 5, 1), "no_mismatch": (2, 0, 5, 1), "3,2,4,2": (3, 2, 4, 2),
    "16,12,20,8": (16, 12, 20, 8), "match_0": (0, 3, 5, 1), "all_0": (0, 0, 0, 0),
    "gaps_0": (2, 3, 0, 0),
    "mismatch_bonus_1": (1, -1, 5, 1), "mismatch_bonus_1000": (1, -1000, 5, 1),
    "gap_open_bonus_5": (2, 3, -5, 1), "gap_extend_bonus_1": (2, 3, 5, -1),
    "gap_extend_bonus_1000": (2, 3, 5, -1000), "gap_open_bonus_2000": (2, 3, -2000, 1),
    "match_-1": (-1, 3, 5, 1), "match_-128": (-128, 3, 5, 1), "match_-129": (-129, 3, 5, 1),
    "match_-200": (-200, 3, 5, 1), "match_127": (127, 3, 5, 1), "match_128": (128, 3, 5, 1),
    "match_200": (200, 3, 5, 1), "mismatch_128": (2, 128, 5, 1), "mismatch_129": (2, 129, 5, 1),
    "forbid_mismatch": (2, 1_000_000, 5, 1), "forbid_gaps": (2, 3, 1_000_000, 1_000_000),
    "gap_open_2e6": (2, 3, 2_000_000, 1), "gap_extend_3e6": (2, 3, 5, 3_000_000),
    **{f"{name}_2^20{d}": tuple((2, 3, 5, 1)[:k]) + ((1 << 20) + int(d or 0),)
       + tuple((2, 3, 5, 1)[k + 1:])
       for k, name in enumerate(("match", "mismatch", "gap_open", "gap_extend"))
       for d in ("-1", "")},
    "gap_extend_x_Lt_2^26-1": lambda Lq, Lt: (2, 3, 5, (2**26 - 1) // max(Lt, 1)),
    "gap_extend_x_Lt_2^26": lambda Lq, Lt: (2, 3, 5, _ceil(2**26, max(Lt, 1))),
    "score_limit_2^28-1": lambda Lq, Lt: ((2**28 - 1) // max(min(Lq, Lt), 1), 3, 5, 1),
    "score_limit_2^28": lambda Lq, Lt: (_ceil(2**28, max(min(Lq, Lt), 1)), 3, 5, 1),
    # at Lq 40 x Lt 2^16: U = 32,760, and E + ge * j of the packed form
    # within int32 at ge = 32,750, past it at 32,760 (gaps open for 5)
    "headroom_below": (819, 3, 5 - 32750, 32750), "headroom_at": (819, 3, 5 - 32760, 32760),
}

# name: (B, Lq, Lt, codes); the code variants share one shape
VARIANTS = {
    "empty_batch": (0, 8, 16, "random"), "1x1": (2, 1, 1, "one_match"),
    "lq_1": (3, 1, 50, "random"), "lt_1": (3, 50, 1, "random"), "lt_0": (2, 5, 0, "random"),
    "lq_0": (2, 0, 5, "random"),
    **{f"strip_{32 * R + d}": (2, 32 * R + d, 48, "random") for R in (2, 4, 8)
       for d in (-1, 0, 1)},
    "pair_64x128": (2, 64, 128, "random"),
    **{v: (3, 40, 70, v) for v in ("n_mid", "trailing_pad", "codes_5_to_127",
                                   "negative_codes", "all_n", "planted_ties")},
}
WIDE_VARIANTS = {"lt_65536": (2, 40, 1 << 16, "random"),
                 "lt_65537": (2, 40, (1 << 16) + 1, "random"),
                 "lq_2049": (2, 2049, 300, "random"), "lq_10240": (1, 10240, 512, "random")}
CORE_VARIANTS = ("1x1", "lt_0", "strip_65", "strip_129", "pair_64x128", "n_mid",
                 "trailing_pad", "codes_5_to_127", "negative_codes", "all_n", "planted_ties")
CORE_PARAMS = ("default", "mismatch_bonus_1000", "gap_extend_bonus_1", "gap_open_bonus_2000",
               "match_-200", "forbid_gaps")
WIDE = [("default", v) for v in WIDE_VARIANTS] + [
    ("headroom_below", "lt_65536"), ("headroom_at", "lt_65536"),
    ("gap_extend_x_Lt_2^26", "lt_65536"),
    *[(p, v) for v in ("lq_2049", "lq_10240") for p in CORE_PARAMS[1:]]]
# the codes a caller may assert no_n for: every code a base 0-3 or a trailing pad
NO_N_CODES = ("random", "one_match", "trailing_pad", "all_n", "planted_ties")


def cases(card: bool = False):
    """Every case's name, "<params>/<variant>": on the CPU, each parameter
    set with the core variants and each variant with the core parameter
    sets; on the card (``card``) the wide cases too."""
    names = [f"{p}/{v}" for p in PARAMS if p not in ("headroom_below", "headroom_at")
             for v in CORE_VARIANTS]
    names += [f"{p}/{v}" for v in VARIANTS if v not in CORE_VARIANTS for p in CORE_PARAMS]
    if card:
        names += [f"{p}/{v}" for p, v in WIDE]
    return names


def case(name: str) -> dict:
    """The case's inputs: ``q`` [B, Lq] and ``t`` [B, Lt] int8, ``params``
    (SWParams), ``no_n`` (whether the codes let a caller assert no_n)."""
    p_name, v_name = name.split("/")
    B, Lq, Lt, codes = {**VARIANTS, **WIDE_VARIANTS}[v_name]
    p = PARAMS[p_name]
    params = SWParams(*(p(Lq, Lt) if callable(p) else p))
    rng = np.random.default_rng([list(PARAMS).index(p_name),
                                 list({**VARIANTS, **WIDE_VARIANTS}).index(v_name)])
    q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.int8)
    for b in range(0, B, 2):  # a copy of part of the query in every other target
        n = min(Lq, Lt) // 2
        if n:
            at = int(rng.integers(0, Lt - n + 1))
            t[b, at:at + n] = q[b, :n]
    if codes == "one_match":
        q[:] = 0
        t[:] = np.arange(B).reshape(B, 1) % 4
    elif codes == "n_mid":
        q[rng.random(q.shape) < 0.05] = 4
        t[rng.random(t.shape) < 0.05] = 4
    elif codes == "trailing_pad":
        for a, lengths in ((q, [Lq, Lq // 2, 0]), (t, [Lt // 3, Lt, Lt - 1])):
            for b, n in enumerate(lengths):
                a[b, n:] = 4
    elif codes == "codes_5_to_127":
        for a in (q, t):
            odd = rng.random(a.shape) < 0.1
            a[odd] = rng.integers(5, 128, int(odd.sum()))
    elif codes == "negative_codes":
        for a in (q, t):
            neg = rng.random(a.shape) < 0.1
            a[neg] = rng.integers(-128, 0, int(neg.sum()))
        q[:, 3:15] = t[:, 20:32] = np.resize([-1, -128, -7, -1, 0, -2], 12)  # equal ones meet
    elif codes == "all_n":
        q[:] = 4
        t[:] = 4
    elif codes == "planted_ties":
        q[:] = np.resize(np.array([0, 1], np.int8), Lq)
        t[:] = np.resize(np.array([0, 1], np.int8), Lt)
        t[:, 30:] = 2
    return dict(q=q, t=t, params=params, no_n=codes in NO_N_CODES)


def held_on_card(name: str, device) -> dict:
    """The case through ``sw_score_cuda`` on the card against the plain
    version, exact (the plain version runs on the host's CPU: the same
    int32 operations, and far fewer microseconds a diagonal than the card's
    op-by-op launches at Lt = 2^16): at the plan's own form, R, pack and no_n,
    then at every R forced (each form), packed as the plan has it and
    forced unpacked; with no_n too where the codes allow it. Where the
    wrapper's admission refuses (the TPU kernel's limit, Lq = 0) the card
    raises ``ValueError`` and launches nothing. Returns the launches it
    made by form and whether it refused. Raises ``AssertionError`` where
    the card and the plain version differ."""
    import torch

    from breakmer_tpu_torch.ops import sw_cuda
    from breakmer_tpu_torch.ops.sw import sw_score

    c = case(name)
    q, t = (torch.from_numpy(c[k]).to(device) for k in ("q", "t"))
    params = c["params"]
    B, Lq, Lt = q.shape[0], q.shape[1], t.shape[1]
    made = {"ticket": 0, "block": 0, "refused": False}

    def launches():
        return dict(sw_cuda.LAUNCHES_BY_FORM, all=sw_cuda.LAUNCHES)

    try:
        sw_cuda.admit(B, Lq, Lt, params)
    except ValueError:
        before = launches()
        try:
            sw_cuda.sw_score_cuda(q, t, params)
        except ValueError:
            made["refused"] = True
        torch.cuda.synchronize()
        assert made["refused"] and launches() == before, (name, "not refused")
        return made
    want = tuple(x.to(device) for x in sw_score(torch.from_numpy(c["q"]),
                                                 torch.from_numpy(c["t"]), params))
    runs = [(None, False)] + [(R, unpacked) for R in (*sw_cuda.BLOCK_ROWS_PER_LANE,
                                                      *sw_cuda.ROWS_PER_LANE)
                              if sw_cuda._fits(R, Lq, Lt) for unpacked in (False, True)]
    for no_n in (False, True) if c["no_n"] else (False,):
        for R, unpacked in runs:
            before = launches()
            got = sw_cuda.sw_score_cuda(q, t, params, no_n=no_n, rows_per_lane=R,
                                        unpacked=unpacked)
            torch.cuda.synchronize()
            plan = sw_cuda.admit(B, Lq, Lt, params, no_n, R, unpacked,
                                 sw_cuda._sms(q.device)).plan
            after = launches()
            if plan is None:
                assert after == before, (name, "launched with nothing to launch")
            else:
                assert after == dict(before, all=before["all"] + 1,
                                     **{plan.form: before[plan.form] + 1}), (name, plan)
                made[plan.form] += 1
            for what, a, b in zip(("score", "q_end", "t_end"), want, got):
                assert a.dtype == b.dtype and torch.equal(a, b), \
                    (name, what, f"no_n={no_n} R={R} unpacked={unpacked}")
    return made
