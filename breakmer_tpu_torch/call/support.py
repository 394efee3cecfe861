"""Split-read and discordant-pair support counting.

Reference (SURVEY.md §2 #13): split reads are the contig's own reads that
overlap a junction position by at least N bases on both sides (the
assembler records each read's contig offset precisely for this);
discordant pairs come from the extractor's mate-location map (reference:
target.extract_bam_reads records discordant pairs keyed by mate chrom) and
support an event when the two mates land near the two breakpoints.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from breakmer_tpu_torch.assemble.greedy import Contig


def count_split_reads(
    contig: Contig, junction_qpos: int, min_overlap: int = 5
) -> int:
    """Reads spanning ``junction_qpos`` (forward contig coordinate) by at
    least ``min_overlap`` bases on each side."""
    n = 0
    for r in contig.reads:
        if (
            r.offset + min_overlap <= junction_qpos
            and junction_qpos <= r.offset + r.length - min_overlap
        ):
            n += 1
    return n


@dataclasses.dataclass
class DiscordantPairs:
    """Discordant read pairs anchored in the target region.

    pairs: [(anchor_chrom, anchor_pos, mate_chrom, mate_pos)] — one entry
    per pair (the anchor is the region-side mate). The reference keeps a
    dict keyed by mate chrom (target.extract_bam_reads); this is the same
    information with positions retained for breakpoint-window matching.
    """

    pairs: List[Tuple[str, int, str, int]] = dataclasses.field(default_factory=list)

    def add(self, anchor_chrom: str, anchor_pos: int, mate_chrom: str, mate_pos: int):
        self.pairs.append((anchor_chrom, anchor_pos, mate_chrom, mate_pos))

    def __len__(self) -> int:
        return len(self.pairs)

    def support(
        self,
        bp1: Tuple[str, int],
        bp2: Tuple[str, int],
        window: int = 1000,
    ) -> int:
        """Pairs with one mate within ``window`` of bp1 and the other
        within ``window`` of bp2 (either orientation)."""
        c1, p1 = bp1
        c2, p2 = bp2
        n = 0
        for ac, ap, mc, mp in self.pairs:
            near_1a = ac == c1 and abs(ap - p1) <= window
            near_2m = mc == c2 and abs(mp - p2) <= window
            near_2a = ac == c2 and abs(ap - p2) <= window
            near_1m = mc == c1 and abs(mp - p1) <= window
            if (near_1a and near_2m) or (near_2a and near_1m):
                n += 1
        return n
