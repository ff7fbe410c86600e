"""Optimizer, learning-rate schedule and module freezing (counterpart of
``softgroup_tpu/util/optim.py``: ``build_optimizer``,
``cosine_after_step_schedule``, ``freeze_mask`` / ``masked_optimizer``).

Frozen modules get ``requires_grad_(False)``: the reference's own freezing,
and the counterpart of excluding them from ``value_and_grad``; the
optimizer holds the trainable parameters only.  The learning rate of each
update is set by the train step (``train.TrainStep``) from the schedule,
as ``optax.adam(schedule)`` reads it from its update count.
"""

from __future__ import annotations

import math

import torch
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


def build_optimizer(params, cfg, schedule=None) -> torch.optim.Optimizer:
    """cfg: dict(type='Adam'|'AdamW'|'SGD', lr=..., [b1, b2, eps,
    weight_decay, momentum]), with the arguments the reference passes to
    optax: Adam's ``b1`` / ``b2`` / ``eps`` where given (else optax's 0.9,
    0.999, 1e-8), AdamW's ``weight_decay`` (default 1e-2, optax's other
    defaults), SGD's ``momentum`` (default 0.9).  The initial learning rate
    is ``schedule(0)``, or ``cfg.lr`` without a schedule."""
    otype = cfg.get('type', 'Adam').lower()
    lr = schedule(0) if schedule is not None else cfg['lr']
    if otype == 'adam':
        return torch.optim.Adam(
            params, lr=lr, betas=(cfg.get('b1', 0.9), cfg.get('b2', 0.999)),
            eps=cfg.get('eps', 1e-8))
    if otype == 'adamw':
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8,
                                 weight_decay=cfg.get('weight_decay', 1e-2))
    if otype == 'sgd':
        return torch.optim.SGD(params, lr=lr,
                               momentum=cfg.get('momentum', 0.9))
    raise ValueError(f'unknown optimizer {cfg.get("type")}')
