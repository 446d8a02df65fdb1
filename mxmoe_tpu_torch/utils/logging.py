"""Console + file logger (port of ``mxmoe_tpu/utils/logging.py``, the
reference's ``logger_utils.py:10-58``)."""

from __future__ import annotations

import logging
import os
import sys
from datetime import datetime

_FMT = "[%(asctime)s] %(levelname)s %(name)s: %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


def setup_logger(
    name: str = "mxmoe_tpu_torch",
    log_dir: str | None = None,
    level: int = logging.INFO,
    tag: str | None = None,
) -> logging.Logger:
    """Logger with console output and optional per-run file
    (``log/<tag>_<timestamp>.log``, the reference's naming scheme). A later
    call for the same name writes to the ``sys.stdout`` of that call and,
    given ``log_dir``, to a new file there in place of the earlier one."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(level)
        logger.propagate = False
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter(_FMT, _DATEFMT))
        logger.addHandler(sh)
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            if log_dir:
                logger.removeHandler(h)
                h.close()
        elif isinstance(h, logging.StreamHandler):
            h.setStream(sys.stdout)

    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        fname = f"{tag or name}_{ts}.log"
        fh = logging.FileHandler(os.path.join(log_dir, fname))
        fh.setFormatter(logging.Formatter(_FMT, _DATEFMT))
        logger.addHandler(fh)
    return logger


def init_logger(name: str = "mxmoe_tpu_torch") -> logging.Logger:
    return setup_logger(name)
