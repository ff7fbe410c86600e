"""Logging: ``get_root_logger``, a copy of ``softgroup_tpu/util/logger.py``'s
(a rank-0 stream logger, with a file beside it where one is named)."""

from __future__ import annotations

import logging
import os


def get_root_logger(log_file: str | None = None, rank: int = 0,
                    log_level=logging.INFO) -> logging.Logger:
    """The package's logger, set up at its first call: INFO on rank 0
    (ERROR elsewhere) to the stream and, on rank 0, to ``log_file``."""
    logger = logging.getLogger('softgroup_tpu_torch')
    if logger.handlers:
        return logger
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    fmt = logging.Formatter('%(asctime)s - %(levelname)s - %(message)s')
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file and rank == 0:
        os.makedirs(os.path.dirname(log_file) or '.', exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
