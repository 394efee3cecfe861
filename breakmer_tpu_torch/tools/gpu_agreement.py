"""Bit-agreement of the card's SW kernel with the plain version.

Port of ``tools/tpu_agreement.py``, the hardware half of the invariant
that ``ops.sw_cuda`` agrees bit for bit with ``ops.sw.sw_score``: run it
on the card after any change to ``csrc/sw_wavefront.cu``:

    python -m breakmer_tpu_torch.tools.gpu_agreement [--out PATH] [--device cuda]

It compares score, q_end and t_end of ``sw_score_cuda`` with plain
``sw_score`` and exits non-zero on any mismatch. The cases
(``build_cases``):

  - pad tier: the JAX tool's six shapes, 8x128x256 to 8x1024x2048, from
    the same rng and with the same planted rows (an exact hit, an
    end-anchored hit, a mid-sequence N in q and in t, a trailing pad, an
    all-pad row), each in the generic and the ``no_n`` form. Their
    arrays equal the ones the JAX tool hands its kernel.
  - long: the JAX tool's three target-chunked shapes (48x128x512,
    16x256x1024, 8x512x8192). The CUDA kernel has no target chunk; its
    boundaries are the strips' (32 R query rows a warp, strips linked
    through the scratch), so hits straddle every strip boundary at
    R = 4 and 8, N runs sit on those boundaries, and one row is
    tie-heavy.

Each case runs under the automatic launch plan and at every R
(``sw_cuda.ROWS_PER_LANE``), packed and unpacked. ``--out`` writes the
record ``AGREEMENT_r05.json`` holds (``case``, ``paths``, ``checks``,
``pass``, ``mismatches``, ``agreement``), with ``"backend": "cuda"`` and
the card's name. ``--device cpu`` holds the plain version against
itself, a rehearsal of the tool's plumbing with no kernel in it.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

SEED = 20260818
PAD_SHAPES = [(8, 128, 256), (48, 128, 512), (64, 256, 512),
              (512, 256, 512), (16, 512, 1024), (8, 1024, 2048)]
LONG_SHAPES = [(48, 128, 512), (16, 256, 1024), (8, 512, 8192)]


def strip_boundaries(Lq: int) -> list:
    """The query rows where one strip of the kernel ends and the next
    begins, at every R of ``sw_cuda.ROWS_PER_LANE``."""
    from breakmer_tpu_torch.ops.sw_cuda import ROWS_PER_LANE

    return sorted({32 * R * k for R in ROWS_PER_LANE for k in range(1, -(-Lq // (32 * R)))})


def _pad_tier(rng, B, Lq, Lt):
    """The JAX tool's pad-tier case: the generic arrays and the no_n ones."""
    q = rng.integers(0, 4, (B, Lq), dtype=np.int8)
    t = rng.integers(0, 4, (B, Lt), dtype=np.int8)
    # plant structure: exact hits, end-anchored hits, N runs, pad 4s
    t[0, 10:10 + Lq // 2] = q[0, :Lq // 2]
    t[1, Lt - Lq // 2:] = q[1, :Lq // 2]
    q[2, Lq // 3:Lq // 3 + 5] = 4          # mid-sequence N (generic)
    t[3, Lt // 2:Lt // 2 + 9] = 4
    q[4, Lq // 2:] = 4                       # trailing pad
    q[5] = 4                                 # all-pad row
    qn = np.where(q >= 4, 0, q)[:max(8, B // 2)]
    tn = np.where(t >= 4, 0, t)[:max(8, B // 2)]
    return [("generic", q, t, False), ("no_n", qn, tn, True)]


def _long(rng, B, Lq, Lt):
    """A long-target case: N runs on every strip boundary (row 1), then
    hits whose query span straddles each boundary (or the middle query
    row, for a query of one strip), copied into the target at a random column,
    then a tie-heavy row 2. Returns the case and the planted hits as
    (row, q_start, q_end, t_start)."""
    q = rng.integers(0, 4, (B, Lq), dtype=np.int8)
    t = rng.integers(0, 4, (B, Lt), dtype=np.int8)
    bounds = strip_boundaries(Lq)
    for bd in bounds:
        q[1, bd - 4:bd + 4] = 4
        t[1, bd - 4:bd + 4] = 4
    hits = []
    centres = bounds or [Lq // 2]
    for row in range(B):
        bd = centres[row % len(centres)]
        span = min(Lq // 2, 2 * min(bd, Lq - bd))
        s = bd - span // 2
        j0 = int(rng.integers(0, Lt - span + 1))
        t[row, j0:j0 + span] = q[row, s:s + span]
        hits.append((row, s, s + span, j0))
    q[2] = q[2] % 2  # tie-heavy row
    t[2] = t[2] % 2
    return [("long", q, t, False)], hits


def build_cases(rng):
    """Every case of the tool, in order: [(case name, [(path, q, t, no_n)],
    planted hits or None)]. The pad-tier cases come first and draw from
    ``rng`` exactly as the JAX tool does."""
    cases = [(f"{B}x({Lq}x{Lt})", _pad_tier(rng, B, Lq, Lt), None)
             for B, Lq, Lt in PAD_SHAPES]
    for B, Lq, Lt in LONG_SHAPES:
        forms, hits = _long(rng, B, Lq, Lt)
        cases.append((f"strips {B}x({Lq}x{Lt})", forms, hits))
    return cases


def kernel_forms(device: torch.device) -> list:
    """[(label, rows_per_lane, unpacked)]: the launch plan's own and every
    R packed and unpacked on a card; the plain version alone on the CPU."""
    if device.type != "cuda":
        return [("plain", None, False)]
    from breakmer_tpu_torch.ops.sw_cuda import ROWS_PER_LANE

    return [("auto", None, False)] + [
        (f"R{R}{' unpacked' if unpacked else ''}", R, unpacked)
        for R in ROWS_PER_LANE for unpacked in (False, True)]


def _score(q, t, params, no_n, rows_per_lane, unpacked):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    from breakmer_tpu_torch.ops.sw import sw_score

    if q.device.type != "cuda":
        return sw_score(q, t, params)
    from breakmer_tpu_torch.ops.sw_cuda import sw_score_cuda

    return sw_score_cuda(q, t, params, no_n=no_n, rows_per_lane=rows_per_lane,
                         unpacked=unpacked)


def run(device: torch.device, out=sys.stdout) -> dict:
    """Every case on ``device`` against the plain version; the record."""
    from breakmer_tpu_torch.ops.sw import SWParams, sw_score

    on_card = device.type == "cuda"
    record = {"artifact": "bit-agreement on the card: ops.sw_cuda (csrc/sw_wavefront.cu) "
                          "vs the plain ops.sw.sw_score (scores + argmax cells)",
              "backend": "cuda" if on_card else "cpu",
              "device": torch.cuda.get_device_name(device) if on_card else "cpu",
              "cases": []}
    t0 = time.time()
    params = SWParams()
    forms = kernel_forms(device)
    failures = 0
    for case, paths, _ in build_cases(np.random.default_rng(SEED)):
        fail0 = failures
        labels = []
        for name, qq, tt, flag in paths:
            q, t = torch.from_numpy(qq).to(device), torch.from_numpy(tt).to(device)
            want = [x.cpu().numpy() for x in sw_score(q, t, params)]
            for label, R, unpacked in forms:
                got = [x.cpu().numpy() for x in _score(q, t, params, flag, R, unpacked)]
                labels.append(f"{name} {label}")
                for check, a, b in zip(("score", "q_end", "t_end"), want, got):
                    if not np.array_equal(a, b):
                        bad = int(np.nonzero(a != b)[0][0])
                        print(f"MISMATCH {case} {name} {label} {check} row {bad}: "
                              f"plain {a[bad]} kernel {b[bad]}", file=out)
                        failures += 1
        record["cases"].append({"case": case, "paths": labels,
                                "checks": ["score", "q_end", "t_end"],
                                "pass": failures == fail0})
        print(f"ok {case} {len(labels)} paths" if failures == fail0
              else f"FAIL {case}", file=out, flush=True)
    record["mismatches"] = failures
    record["agreement"] = failures == 0
    record["wall_s"] = round(time.time() - t0, 1)
    return record


def main(argv=None) -> int:
    from breakmer_tpu_torch.device import resolve

    ap = argparse.ArgumentParser(prog="python -m breakmer_tpu_torch.tools.gpu_agreement")
    ap.add_argument("--out", default=None, help="write the record here")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    device = resolve(args.device)  # raises without a card unless cpu
    record = run(device)
    if args.out:
        from breakmer_tpu_torch.tools import write_json

        write_json(args.out, record)
    if record["mismatches"]:
        print(f"FAILED: {record['mismatches']} mismatches")
        return 1
    print(f"AGREEMENT: kernel == plain bit-exactly on {record['device']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
