"""Colored console + plain file logging (copy of ``cmh_tpu/utils/logger.py``).

A per-run file handler at ``<log_dir>/<name>.txt`` plus an optional colored
console handler; ANSI codes are emitted directly.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

_COLORS = {
    "DEBUG": "\033[36m",     # cyan
    "INFO": "\033[32m",      # green
    "WARNING": "\033[33m",   # yellow
    "ERROR": "\033[31m",     # red
    "CRITICAL": "\033[35m",  # magenta
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        color = _COLORS.get(record.levelname, "")
        return f"{color}{msg}{_RESET}" if color else msg


def get_logger(log_dir: Optional[str], name: str = "cmh_torch") -> logging.Logger:
    """Plain file logger (no console)."""
    return get_color_logger(log_dir, name, display=False)


def get_color_logger(
    log_dir: Optional[str], name: str = "cmh_torch", display: bool = True
) -> logging.Logger:
    """File logger + (optionally) colored console handler.

    Repeated calls with the same name return the same logger without
    duplicating handlers.
    """
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:
        return logger

    fmt = "%(asctime)s - %(levelname)s - %(message)s"

    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, f"{name}.txt"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)

    if display:
        ch = logging.StreamHandler()
        ch.setLevel(logging.INFO)
        ch.setFormatter(_ColorFormatter(fmt))
        logger.addHandler(ch)
    elif not log_dir:
        logger.addHandler(logging.NullHandler())

    return logger
