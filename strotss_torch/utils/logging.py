"""Logging with the same surface as the JAX package (``utils/logging.py``):
one shared named logger, a stdout handler, the reference's format."""

from __future__ import annotations

import logging
import sys

_NAME = "STROTSS"

logger = logging.getLogger(_NAME)


def make_logger(name: str = _NAME) -> logging.Logger:
    """Attach the stdout handler and format to the named logger."""
    lg = logging.getLogger(name)
    if not lg.handlers:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(
            logging.Formatter(
                "%(asctime)s [%(levelname)s] %(name)s: %(message)s",
                "%Y-%m-%d %H:%M:%S",
            )
        )
        lg.addHandler(sh)
    lg.setLevel(logging.INFO)
    return lg
