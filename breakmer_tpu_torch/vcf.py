"""VCF 4.2 emission alongside the svs.out TSV.

The reference emits only its TSV call table (SURVEY.md §2 #17,
sv_event.get_out_str); downstream tooling today expects VCF, so the
runner also writes ``output/<analysis_name>.vcf``. Event → record
mapping:

  indel I / rearrangement ins  -> <INS>    (SVLEN=+size)
  indel D / rearrangement del  -> <DEL>    (SVLEN=-size, END)
  rearrangement tandem_dup     -> <DUP:TANDEM>
  rearrangement inversion      -> <INV>
  trl                          -> breakend (BND) pair with MATEID

Breakend bracket orientation follows VCF 4.2 §5.4 from the junction's
segment strands (a ends the contig's left part, b starts the right part):

  (+,+): t[c2:P2[   mate  ]c1:P1]t
  (+,-): t]c2:P2]   mate  t]c1:P1]
  (-,+): [c2:P2[t   mate  [c1:P1[t
  (-,-): ]c2:P2]t   mate  t[c1:P1[

Coordinates: the pipeline's breakpoints are 0-based junction coordinates;
for symbolic alleles the VCF POS (1-based base *before* the event) equals
the 0-based junction start numerically, so POS = bp and END = bp_end.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from breakmer_tpu_torch.call.events import SVEvent

VCF_VERSION = "4.2"

_HEADER_LINES = [
    '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">',
    '##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the variant">',
    '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="Length of the variant">',
    '##INFO=<ID=MATEID,Number=1,Type=String,Description="ID of mate breakend">',
    '##INFO=<ID=GENES,Number=1,Type=String,Description="Target gene(s) of the call">',
    '##INFO=<ID=CONTIG,Number=1,Type=String,Description="Assembled contig id">',
    '##INFO=<ID=SUBTYPE,Number=1,Type=String,Description="Caller sv_subtype">',
    '##INFO=<ID=INSSEQ,Number=1,Type=String,Description="Inserted sequence on the reference forward strand">',
    '##ALT=<ID=DEL,Description="Deletion">',
    '##ALT=<ID=INS,Description="Insertion">',
    '##ALT=<ID=DUP:TANDEM,Description="Tandem duplication">',
    '##ALT=<ID=INV,Description="Inversion">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=SR,Number=1,Type=Integer,Description="Split-read support">',
    '##FORMAT=<ID=PE,Number=1,Type=Integer,Description="Discordant-pair support">',
]

RefBaseFn = Callable[[str, int], str]

_RC = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")


def _ins_seq(ev: SVEvent) -> Optional[str]:
    """Inserted bases on the reference forward strand, recovered from the
    assembled contig: ``junction_q`` holds the forward-contig span of the
    novel bases for both insertion shapes (indel 'I' gap and two-segment
    'ins' junction — call/events.py:121,201). None when the span is
    missing, inconsistent with the event size, or the junction strands
    disagree (a mixed-strand junction leaves the insert's reference
    orientation ambiguous)."""
    if len(ev.junction_q) != 2 or not ev.contig_seq:
        return None
    lo, hi = ev.junction_q
    if not (0 <= lo < hi <= len(ev.contig_seq)) or hi - lo != ev.size:
        return None
    strands = ev.strands.split("/")
    if len(set(strands)) != 1:
        return None
    seq = ev.contig_seq[lo:hi]
    return seq.translate(_RC)[::-1] if strands[0] == "-" else seq


def _ref_base(ref_base_at: Optional[RefBaseFn], chrom: str, pos: int) -> str:
    if ref_base_at is None:
        return "N"
    try:
        base = ref_base_at(chrom, pos)
    except Exception:
        return "N"
    return (base or "N").upper()[:1] or "N"


def _symbolic(
    ev: SVEvent,
    rid: str,
    alt: str,
    svtype: str,
    pos: int,
    end: Optional[int],
    svlen: Optional[int],
    ref_base_at: Optional[RefBaseFn],
) -> dict:
    info: Dict[str, object] = {"SVTYPE": svtype}
    if end is not None:
        info["END"] = end
    if svlen is not None:
        info["SVLEN"] = svlen
    info["GENES"] = ev.genes.replace(";", ",")
    info["CONTIG"] = ev.contig_id
    info["SUBTYPE"] = ev.sv_subtype
    return {
        "chrom": ev.breakpoints[0][0],
        "pos": max(1, pos),
        "id": rid,
        "ref": _ref_base(ref_base_at, ev.breakpoints[0][0], max(1, pos)),
        "alt": alt,
        "info": info,
        "sr": ev.split_read_count,
        "pe": ev.disc_read_count,
    }


def _bnd_pair(
    ev: SVEvent, rid: str, ref_base_at: Optional[RefBaseFn]
) -> List[dict]:
    (c1, p1, _), (c2, p2, _) = ev.breakpoints[:2]
    p1, p2 = max(1, p1), max(1, p2)
    s1, s2 = (ev.strands.split("/") + ["+", "+"])[:2]
    t1 = _ref_base(ref_base_at, c1, p1)
    t2 = _ref_base(ref_base_at, c2, p2)
    m1, m2 = f"{c2}:{p2}", f"{c1}:{p1}"
    if (s1, s2) == ("+", "+"):
        alt1, alt2 = f"{t1}[{m1}[", f"]{m2}]{t2}"
    elif (s1, s2) == ("+", "-"):
        alt1, alt2 = f"{t1}]{m1}]", f"{t2}]{m2}]"
    elif (s1, s2) == ("-", "+"):
        alt1, alt2 = f"[{m1}[{t1}", f"[{m2}[{t2}"
    else:  # (-,-)
        alt1, alt2 = f"]{m1}]{t1}", f"{t2}[{m2}["
    base_info = {
        "SVTYPE": "BND",
        "GENES": ev.genes.replace(";", ","),
        "CONTIG": ev.contig_id,
        "SUBTYPE": ev.sv_subtype,
    }
    return [
        {
            "chrom": c1, "pos": p1, "id": f"{rid}_1", "ref": t1, "alt": alt1,
            "info": {**base_info, "MATEID": f"{rid}_2"},
            "sr": ev.split_read_count, "pe": ev.disc_read_count,
        },
        {
            "chrom": c2, "pos": p2, "id": f"{rid}_2", "ref": t2, "alt": alt2,
            "info": {**base_info, "MATEID": f"{rid}_1"},
            "sr": ev.split_read_count, "pe": ev.disc_read_count,
        },
    ]


def event_vcf_records(
    ev: SVEvent,
    rid: str,
    ref_base_at: Optional[RefBaseFn] = None,
) -> List[dict]:
    """Convert one SVEvent into VCF record dict(s); a translocation yields
    a MATEID-linked breakend pair, everything else one symbolic-ALT row."""
    if ev.sv_type == "trl" and len(ev.breakpoints) >= 2:
        return _bnd_pair(ev, rid, ref_base_at)
    chrom, start, end = ev.breakpoints[0]
    if ev.sv_type == "indel" and ev.sv_subtype == "I":
        recs = [_symbolic(ev, rid, "<INS>", "INS", start, start, ev.size,
                          ref_base_at)]
        ins = _ins_seq(ev)
        if ins:
            recs[0]["info"]["INSSEQ"] = ins
        return recs
    if (ev.sv_type, ev.sv_subtype) in (("indel", "D"), ("rearrangement", "del")):
        e = end if end is not None else start + ev.size
        return [_symbolic(ev, rid, "<DEL>", "DEL", start, e, -ev.size,
                          ref_base_at)]
    if ev.sv_subtype == "tandem_dup":
        e = end if end is not None else start + ev.size
        return [_symbolic(ev, rid, "<DUP:TANDEM>", "DUP", start, e, ev.size,
                          ref_base_at)]
    if ev.sv_subtype == "inversion":
        if end is None and len(ev.breakpoints) >= 2:
            lo, hi = sorted((start, ev.breakpoints[1][1]))
        else:
            lo, hi = start, end if end is not None else start + ev.size
        return [_symbolic(ev, rid, "<INV>", "INV", lo, hi, hi - lo,
                          ref_base_at)]
    if ev.sv_subtype == "ins":
        recs = [_symbolic(ev, rid, "<INS>", "INS", start, start, ev.size,
                          ref_base_at)]
        ins = _ins_seq(ev)
        if ins:
            recs[0]["info"]["INSSEQ"] = ins
        return recs
    # unknown subtype: still emit something inspectable
    return [_symbolic(ev, rid, "<SV>", ev.sv_type.upper(), start, end,
                      ev.size or None, ref_base_at)]


def _info_str(info: Dict[str, object]) -> str:
    return ";".join(f"{k}={v}" for k, v in info.items())


def write_vcf(
    path: str | Path,
    records: Sequence[dict],
    contigs: Sequence[Tuple[str, int]] = (),
    sample: str = "SAMPLE",
    reference: Optional[str] = None,
) -> None:
    """Write record dicts (from event_vcf_records) as a sorted VCF file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    order = {name: i for i, (name, _ln) in enumerate(contigs)}
    recs = sorted(
        records,
        key=lambda r: (order.get(r["chrom"], len(order)), r["chrom"],
                       r["pos"], r["id"]),
    )
    with open(path, "w") as fh:
        fh.write(f"##fileformat=VCFv{VCF_VERSION}\n")
        fh.write("##source=breakmer_tpu\n")
        if reference:
            fh.write(f"##reference={reference}\n")
        for name, ln in contigs:
            fh.write(f"##contig=<ID={name},length={ln}>\n")
        for line in _HEADER_LINES:
            fh.write(line + "\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 f"{sample}\n")
        for r in recs:
            fh.write(
                "\t".join([
                    r["chrom"], str(r["pos"]), r["id"], r["ref"], r["alt"],
                    ".", "PASS", _info_str(r["info"]),
                    "GT:SR:PE", f"./.:{r['sr']}:{r['pe']}",
                ]) + "\n"
            )


def read_vcf(path: str | Path) -> List[dict]:
    """Minimal VCF reader for tests: returns body rows as dicts with a
    parsed ``info`` dict."""
    rows: List[dict] = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            info = dict(
                kv.split("=", 1) if "=" in kv else (kv, True)
                for kv in f[7].split(";")
            )
            rows.append({
                "chrom": f[0], "pos": int(f[1]), "id": f[2], "ref": f[3],
                "alt": f[4], "filter": f[6], "info": info,
                "fmt": dict(zip(f[8].split(":"), f[9].split(":")))
                if len(f) > 9 else {},
            })
    return rows
