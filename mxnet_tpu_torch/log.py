"""Logging helpers (reference: python/mxnet/log.py).

The PyTorch counterpart of ``mxnet_tpu/log.py``.

`get_logger(name, filename, filemode, level)` returns a configured
logging.Logger with the reference's level-letter + timestamp format and
ANSI colors on TTYs.
"""
from __future__ import annotations

import logging
import sys

DEBUG = logging.DEBUG
INFO = logging.INFO
WARNING = logging.WARNING
ERROR = logging.ERROR
CRITICAL = logging.CRITICAL
NOTSET = logging.NOTSET

_LEVEL_CHAR = {DEBUG: "D", INFO: "I", WARNING: "W", ERROR: "E",
               CRITICAL: "C"}
_COLOR = {DEBUG: "\x1b[32m", INFO: "\x1b[32m", WARNING: "\x1b[33m",
          ERROR: "\x1b[31m", CRITICAL: "\x1b[35m"}

__all__ = ["get_logger", "getLogger", "DEBUG", "INFO", "WARNING", "ERROR",
           "CRITICAL", "NOTSET"]


class _Formatter(logging.Formatter):
    """Level-letter + date format, colorized on TTY handlers
    (reference: log.py _Formatter)."""

    def __init__(self, colored=True):
        self._colored = colored
        super().__init__(datefmt="%m%d %H:%M:%S")

    def format(self, record):
        char = _LEVEL_CHAR.get(record.levelno, "U")
        fmt = f"{char}%(asctime)s %(process)d %(pathname)s:%(lineno)d] " \
              f"%(message)s"
        if self._colored:
            color = _COLOR.get(record.levelno, "\x1b[34m")
            fmt = color + fmt[:1] + "\x1b[0m" + fmt[1:]
        self._style._fmt = fmt
        return super().format(record)


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """Configured logger (idempotent per name); file handlers are
    uncolored (reference: log.py get_logger)."""
    logger = logging.getLogger(name)
    # name=None is the ROOT logger: return it untouched (the reference
    # guards the same way) — attaching a handler there would reformat
    # every library's propagated records
    if name is None or getattr(logger, "_mx_init_done", False):
        return logger
    logger._mx_init_done = True
    if filename:
        handler = logging.FileHandler(filename, filemode or "a")
        handler.setFormatter(_Formatter(colored=False))
    else:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_Formatter(
            colored=getattr(sys.stderr, "isatty", lambda: False)()))
    logger.addHandler(handler)
    logger.setLevel(level)
    return logger


def getLogger(name=None, filename=None, filemode=None, level=WARNING):
    """Deprecated alias kept for reference parity."""
    return get_logger(name, filename, filemode, level)
