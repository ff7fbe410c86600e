"""Learning-rate schedule and module freezing (counterpart of
``softgroup_tpu/util/optim.py``: ``cosine_after_step_schedule``,
``freeze_mask`` / ``masked_optimizer``).

Frozen modules get ``requires_grad_(False)``: the reference's own freezing,
and the counterpart of excluding them from ``value_and_grad``; the
optimizer (``torch.optim.Adam``, built by ``entry.build_train_state``)
holds the trainable parameters only.
"""

from __future__ import annotations

import math

from torch import nn


def cosine_after_step_schedule(base_lr: float, step_epoch: int,
                               total_epochs: int, steps_per_epoch: int):
    """Constant lr until ``step_epoch``, then cosine decay to 0 at the end
    of training (``clip(epoch - step_epoch, 0)`` cosine)."""

    def schedule(step: int) -> float:
        epoch = step / max(steps_per_epoch, 1)
        t = max(epoch - step_epoch, 0.0)
        span = max(total_epochs - step_epoch, 1)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t / span))

    return schedule


def freeze(net: nn.Module, fixed_modules) -> list:
    """``requires_grad_(False)`` on every parameter under a top-level module
    named in ``fixed_modules``; returns the trainable parameters."""
    fixed = set(fixed_modules)
    trainable = []
    for name, p in net.named_parameters():
        frozen = name.split('.')[0] in fixed
        p.requires_grad_(not frozen)
        if not frozen:
            trainable.append(p)
    return trainable
