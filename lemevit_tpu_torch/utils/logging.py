"""Logging to the console and, tee'd, to a rotating file: counterpart of
lemevit_tpu/utils/logging.py::setup_logging (2 MB x 3 rotation)."""
from __future__ import annotations

import logging
import logging.handlers
from typing import Optional


def setup_logging(log_path: Optional[str] = None,
                  level: int = logging.INFO,
                  rank: int = 0) -> logging.Logger:
    """The "lemevit_tpu_torch" logger: console, and on rank 0 a rotating
    file at ``log_path``. Handlers of an earlier call are closed."""
    logger = logging.getLogger("lemevit_tpu_torch")
    logger.setLevel(level if rank == 0 else logging.WARNING)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_path and rank == 0:
        fh = logging.handlers.RotatingFileHandler(
            log_path, maxBytes=2 * 1024 * 1024, backupCount=3)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
