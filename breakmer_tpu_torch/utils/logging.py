"""Logging (reference: utils.py setup_logger/log — file + console)."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

_LOGGER_NAME = "breakmer_tpu"


def setup_logger(
    analysis_dir: Optional[str] = None, level: str = "INFO"
) -> logging.Logger:
    """Configure the package logger: console + <analysis_dir>/log.txt
    (mirrors the reference's log file layout)."""
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s", "%Y-%m-%d %H:%M:%S"
    )
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if analysis_dir:
        Path(analysis_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(Path(analysis_dir) / "log.txt")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def get_logger(child: Optional[str] = None) -> logging.Logger:
    name = f"{_LOGGER_NAME}.{child}" if child else _LOGGER_NAME
    return logging.getLogger(name)
