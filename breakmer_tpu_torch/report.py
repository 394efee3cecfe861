"""Output / reporting: the svs.out TSV writer.

Reference: runner's aggregate writer + sv_event.get_out_str (SURVEY.md §2
#17): per-target ``<gene>_svs.out`` and aggregate
``output/<analysis_name>_svs.out``. Column set mirrors the reconstructed
reference columns.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence

from breakmer_tpu_torch.call.events import SVEvent

COLUMNS = [
    "genes",
    "target_breakpoints",
    "align_cigar",
    "mismatches",
    "strands",
    "total_matching",
    "sv_type",
    "sv_subtype",
    "split_read_count",
    "disc_read_count",
    "breakpoint_coverages",
    "contig_id",
    "contig_seq",
]


def event_row(ev: SVEvent) -> List[str]:
    return [
        ev.genes,
        ev.breakpoints_str(),
        ev.align_cigar,
        str(ev.mismatches),
        ev.strands,
        str(ev.total_matching),
        ev.sv_type,
        ev.sv_subtype,
        str(ev.split_read_count),
        str(ev.disc_read_count),
        ",".join(str(c) for c in ev.breakpoint_coverages),
        ev.contig_id,
        ev.contig_seq,
    ]


def write_svs_out(path: str | Path, events: Sequence[SVEvent]) -> None:
    write_svs_rows(path, [event_row(ev) for ev in events])


def write_svs_rows(path: str | Path, rows: Sequence[Sequence[str]]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\t".join(COLUMNS) + "\n")
        for row in rows:
            fh.write("\t".join(row) + "\n")


def read_svs_out(path: str | Path) -> List[dict]:
    rows: List[dict] = []
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        for line in fh:
            rows.append(dict(zip(header, line.rstrip("\n").split("\t"))))
    return rows
