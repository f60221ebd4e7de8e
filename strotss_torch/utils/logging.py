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


def route_to_stderr() -> logging.Logger:
    """Point the shared logger's stream handlers at stderr.

    The serving loop's stdout is its JSONL results stream by default; one
    INFO line (the weights loader, ``write_image``, the warm-up) in it
    would break a consumer's parse. The CLI keeps the stdout handler.
    """
    lg = make_logger()
    for h in lg.handlers:
        if isinstance(h, logging.StreamHandler):
            try:
                h.setStream(sys.stderr)
            except ValueError:
                # setStream flushes the old stream first, which fails when
                # that stream is already closed: swap without the flush
                h.stream = sys.stderr
    return lg
