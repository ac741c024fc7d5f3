"""Logger factory (capability parity with reference utils/logger.py:76-92):
ANSI-colored stream handler, optional plain file handler, level from the
``DCFP_LOGGING_LEVEL`` env var."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_LEVEL = os.environ.get("DCFP_LOGGING_LEVEL", "INFO").upper()
_COLORS = {"WARNING": 33, "INFO": 32, "DEBUG": 36, "ERROR": 31,
           "CRITICAL": 35}


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelname, 37)
            return f"\x1b[{color}m{msg}\x1b[0m"
        return msg


_configured = False


def get_logger(name: str = "dcfp_tpu_torch",
               log_file: Optional[str] = None) -> logging.Logger:
    global _configured
    logger = logging.getLogger(name)
    if not _configured:
        logger.setLevel(getattr(logging, _LEVEL, logging.INFO))
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(_ColorFormatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.propagate = False
        _configured = True
    if log_file:
        if not any(isinstance(h, logging.FileHandler) and
                   getattr(h, "baseFilename", None) == os.path.abspath(
                       log_file)
                   for h in logger.handlers):
            os.makedirs(os.path.dirname(os.path.abspath(log_file)),
                        exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s"))
            logger.addHandler(fh)
    return logger
