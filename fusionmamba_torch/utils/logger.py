"""Timestamped file and stream logger (reference `logger.py:13-21`), as the
JAX package's `utils/logger.py` writes it: the same file name and format.
Rank 0 logs at INFO and every other rank at ERROR, the rank read from
`torch.distributed` (rank 0 when no process group is up)."""
from __future__ import annotations

import logging
import os
import time

import torch.distributed as dist

FORMAT = "%(levelname)s %(filename)s(%(lineno)d): %(message)s"


def rank_log_level() -> int:
    """INFO on rank 0 (or without a process group), ERROR elsewhere."""
    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        return logging.ERROR
    return logging.INFO


def setup_logger(name: str = "Net", logpth: str = "logs") -> logging.Logger:
    """A logger writing to `<logpth>/<name>-<time>.log` and to stderr."""
    os.makedirs(logpth, exist_ok=True)
    logfile = os.path.join(logpth, "{}-{}.log".format(name, time.strftime("%Y-%m-%d-%H-%M-%S")))
    log = logging.getLogger(name)
    log.setLevel(rank_log_level())
    if not log.handlers:
        for handler in (logging.FileHandler(logfile), logging.StreamHandler()):
            handler.setFormatter(logging.Formatter(FORMAT))
            log.addHandler(handler)
    return log
