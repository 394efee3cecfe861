"""Utility subsystems: logging, repeat-mask intervals, contig complexity.

Reference: utils.py (setup_logger/log, setup_rmask + interval checks,
calc_contig_complexity — SURVEY.md §2 #15, #18).
"""

from breakmer_tpu_torch.utils.logging import get_logger, setup_logger
from breakmer_tpu_torch.utils.rmask import RepeatMask
from breakmer_tpu_torch.utils.complexity import contig_complexity

__all__ = ["get_logger", "setup_logger", "RepeatMask", "contig_complexity"]
