"""The planted truth against the calls a run wrote (its VCF).

A frozen copy of the scenario checkers (``testing/scenarios.py``), read
from the VCF records instead of the caller's event objects, with their
tolerances: an insertion within 2 bases of its size and ``tol`` of its
junction (and, where the call carries INSSEQ at the exact size, the
inserted bases themselves), a deletion within 4 of its size at its
left-aligned junction, a tandem duplication within 5 of its size with
both ends within ``tol``, an inversion with both ends within ``tol``, a
translocation with both breakends within ``tol`` and at least two
discordant pairs. A germline SV of the matched normal must not be called.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

from svbench.gen.sample import SV

GERMLINE_WINDOW = 60  # a call this close to a germline SV is that SV, called somatic
NEAR_PLANTED = 500  # a call farther than this from every planted junction is false

_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i


def read_vcf(path: Path, pos_bits: int = 0) -> List[dict]:
    """Body rows; ``pos_bits`` holds POS and END at that many bits (a control)."""
    cut = (lambda v: v & ((1 << pos_bits) - 1)) if pos_bits else (lambda v: v)  # noqa: E731
    rows = []
    for line in Path(path).read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        f = line.split("\t")
        info = dict(kv.split("=", 1) if "=" in kv else (kv, "") for kv in f[7].split(";"))
        sr, pe = (int(x) for x in f[9].split(":")[1:3])
        if "END" in info:
            info["END"] = str(cut(int(info["END"])))
        rows.append({"chrom": f[0], "pos": cut(int(f[1])), "id": f[2], "alt": f[4], "info": info,
                     "sr": sr, "pe": pe, "genes": set(info.get("GENES", "").split(","))})
    return rows


def _svlen(r: dict) -> int:
    return abs(int(r["info"].get("SVLEN", 0)))


def _end(r: dict) -> int:
    return int(r["info"].get("END", r["pos"]))


def check_sv(sv: SV, recs: List[dict], genome) -> List[str]:
    """Failure descriptions; empty where the SV was called."""
    sub = lambda r: r["info"].get("SUBTYPE")  # noqa: E731
    if sv.kind == "ins":
        hits = [r for r in recs if sub(r) == "I" and abs(_svlen(r) - sv.size) <= 2
                and abs(r["pos"] - sv.mid) <= sv.tol]
        if not hits:
            return [f"ins@{sv.chrom}:{sv.mid}+{sv.size} not called"]
        for r in hits:
            s = r["info"].get("INSSEQ")
            if _svlen(r) != sv.size or not s:
                continue
            p = r["pos"]
            w = np.concatenate([genome.fetch(sv.chrom, p - 30, p), _CODE[np.frombuffer(s.encode(), np.uint8)],
                                genome.fetch(sv.chrom, p, p + 30)])
            alt = sv.alt_local
            if not any((alt[i:i + len(w)] == w).all() for i in range(len(alt) - len(w) + 1)):
                return [f"ins@{sv.chrom}:{sv.mid} content mismatch: called {p}+{s}"]
        return []
    if sv.kind == "del":
        hits = [r for r in recs if sub(r) in ("D", "del") and abs(_svlen(r) - sv.size) <= 4
                and abs(r["pos"] - sv.mid_norm) <= 4]
        return [] if hits else [f"del@{sv.chrom}:{sv.mid}({sv.mid_norm})+{sv.size} not called"]
    if sv.kind == "dup":
        hits = [r for r in recs if sub(r) == "tandem_dup" and abs(_svlen(r) - sv.size) <= 5]
        if not hits:
            return [f"dup@{sv.chrom}:{sv.mid}-{sv.size} not called"]
        good = [r for r in hits if abs(r["pos"] - (sv.mid - sv.size)) <= sv.tol
                and abs(_end(r) - sv.mid) <= sv.tol]
        return [] if good else [f"dup@{sv.chrom}:{sv.mid}-{sv.size} breakpoints off (tol {sv.tol})"]
    if sv.kind == "inv":
        hits = [r for r in recs if sub(r) == "inversion"]
        if not hits:
            return [f"inv@{sv.chrom}:{sv.mid}+{sv.size} not called"]
        ends = [p for r in hits for p in (r["pos"], _end(r))]
        fails = []
        if not any(abs(p - sv.mid) <= sv.tol for p in ends):
            fails.append(f"inv@{sv.chrom}:{sv.mid} left end missed (tol {sv.tol})")
        if not any(abs(p - (sv.mid + sv.size)) <= sv.tol for p in ends):
            fails.append(f"inv@{sv.chrom}:{sv.mid + sv.size} right end missed (tol {sv.tol})")
        return fails
    bnd = [r for r in recs if r["info"].get("SVTYPE") == "BND"]
    if not bnd:
        return [f"trl@{sv.chrom}:{sv.mid}->{sv.chrom2}:{sv.p2} not called"]
    fails = []
    if not any(r["chrom"] == sv.chrom and abs(r["pos"] - sv.mid) <= sv.tol for r in bnd):
        fails.append(f"trl {sv.chrom}:{sv.mid} breakend missed (tol {sv.tol})")
    if not any(r["chrom"] == sv.chrom2 and abs(r["pos"] - sv.p2) <= sv.tol for r in bnd):
        fails.append(f"trl {sv.chrom2}:{sv.p2} breakend missed (tol {sv.tol})")
    if not any(r["pe"] >= 2 for r in bnd):
        fails.append("trl discordant-pair support < 2")
    return fails


def check_sample(svs: List[SV], vcf: Path, genome, pos_bits: int = 0) -> Dict[str, object]:
    """Per sample: somatic SVs planted and missed, germline SVs called, and
    calls that lie near no planted junction."""
    recs = read_vcf(vcf, pos_bits)
    by_gene: Dict[str, List[dict]] = {}
    for r in recs:
        for gname in r["genes"]:
            by_gene.setdefault(gname, []).append(r)
    missed, leaks = [], []
    somatic = [sv for sv in svs if not sv.germline]
    for sv in somatic:
        fails = check_sv(sv, by_gene.get(sv.gene, []), genome)
        if fails:
            missed.append(fails[0])
    for sv in (sv for sv in svs if sv.germline):
        near = [r for r in recs if r["chrom"] == sv.chrom and abs(r["pos"] - sv.mid) <= GERMLINE_WINDOW]
        if near:
            leaks.append(f"germline ins@{sv.chrom}:{sv.mid} called somatic")
    junctions = [j for sv in svs for j in sv.junctions]
    false = [r for r in recs if not r["id"].endswith("_2")
             and not any(c == r["chrom"] and abs(p - r["pos"]) <= NEAR_PLANTED for c, p in junctions)]
    return {"somatic": len(somatic), "missed": missed, "germline": len(svs) - len(somatic),
            "germline_called": leaks, "calls": sum(1 for r in recs if not r["id"].endswith("_2")),
            "false_calls": [f"{r['chrom']}:{r['pos']} {r['info'].get('SUBTYPE')}" for r in false]}
