"""Logging and scalar summaries (counterpart of ``softgroup_tpu/util/
logger.py``): ``get_root_logger`` (a rank-0 stream logger, with a file
beside it where one is named), ``SummaryWriter`` (rank-0 scalars as JSON
lines, and tensorboard events where ``tensorboardX`` imports),
``AverageMeter`` and ``get_max_memory``."""

from __future__ import annotations

import json
import logging
import os
import time

import torch


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


class SummaryWriter:
    """Rank-0 scalar writer: ``log_dir/scalars.jsonl`` (one record
    ``{t, step, key, value}`` a scalar), and tensorboard events when
    ``tensorboardX`` imports (the reference depends on it; here it is
    optional)."""

    def __init__(self, log_dir: str, rank: int = 0):
        self.rank = rank
        self.tb = None
        if rank != 0:
            return
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, 'scalars.jsonl')
        self._f = open(self.path, 'a')
        try:
            from tensorboardX import SummaryWriter as TBWriter
            self.tb = TBWriter(log_dir)
        except ImportError:
            pass

    def add_scalar(self, key: str, value, step: int):
        if self.rank != 0:
            return
        self._f.write(json.dumps(
            dict(t=time.time(), step=step, key=key, value=float(value))) + '\n')
        self._f.flush()
        if self.tb:
            self.tb.add_scalar(key, value, step)

    def close(self):
        if self.rank == 0:
            self._f.close()
            if self.tb:
                self.tb.close()


def get_max_memory() -> int:
    """Peak memory allocated on the current card since the last reset, in
    MB (the reference's ``max_memory_allocated``); 0 without a card."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return 0
    return torch.cuda.max_memory_allocated() // (1 << 20)


class AverageMeter:
    """Running average (the reference's ``util/utils.py:13-51``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
