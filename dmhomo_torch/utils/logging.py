"""Logger set-up, console and an optional file (the JAX package's
``utils/logging.py``; reference HEM/common/utils.py:133-169)."""

from __future__ import annotations

import logging
import os
from typing import Optional


def get_logger(name: str = "dmhomo", log_file: Optional[str] = None) -> logging.Logger:
    """The named logger at INFO with one console handler; with ``log_file``,
    also one file handler for that path (added once)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        path = os.path.abspath(log_file)
        if not any(isinstance(h, logging.FileHandler) and h.baseFilename == path
                   for h in logger.handlers):
            fh = logging.FileHandler(log_file)
            fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s: %(message)s"))
            logger.addHandler(fh)
    return logger
