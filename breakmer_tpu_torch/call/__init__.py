"""Breakpoint classification, support counting, and the filter stack.

Reference: sv_caller.py ~800-1800 (SURVEY.md §2 #13-14): alignment ->
sv_event classification, split-read / discordant-pair support, and the
repeat / segment-length / support / complexity / intron filters.
"""

from breakmer_tpu_torch.call.events import SVEvent, classify_contig
from breakmer_tpu_torch.call.support import DiscordantPairs, count_split_reads
from breakmer_tpu_torch.call.filters import apply_filters

__all__ = [
    "SVEvent", "classify_contig", "DiscordantPairs", "count_split_reads",
    "apply_filters",
]
