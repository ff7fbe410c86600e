"""The train step (counterpart of ``softgroup_tpu/parallel/mesh.py``
``TrainState`` / ``make_train_step``): ``loss_forward`` -> ``backward`` ->
(with a process group: the gradients, logs and batch-norm statistics
averaged over its ranks, ``parallel/ddp.py``) -> clip -> optimizer step at
the scheduled learning rate.

Frozen modules keep ``requires_grad`` False (no gradient is computed for
them, as the reference leaves them out of ``value_and_grad``), and the
batch norms of frozen backbone modules stay in eval mode (the reference's
``SoftGroupNet._t``); everything else trains.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .model.softgroup import SoftGroupNet
from .parallel.ddp import average_step

# the modules whose batch norms the reference switches by ``_t``
BACKBONE_NORM_MODULES = ('unet', 'output_norm', 'semantic_linear',
                         'offset_linear')


class TrainStep:
    """``step(batch, generator=None, rand=None) -> log_vars`` (detached
    tensors on the batch's device).  ``rand``: the (2, 3) numbers of the
    random quantization, else drawn from ``generator``.

    ``updates`` counts the optimizer's updates; update k (0-based) runs at
    ``schedule(k)`` where a schedule is given (``optax``'s count), else at
    the optimizer's own learning rate.  ``clip_grad_norm``: the global
    norm the trainable gradients are clipped to (none where unset);
    ``grad_norm`` then holds the last step's global norm before the clip
    (a 0-d tensor), else None.

    ``group``: a process group whose ranks each step on their own batch;
    the step then averages over the group, before the clip, the trainable
    gradients (``grad_norm`` is the averaged gradients' norm), the logs it
    returns and the updated batch-norm buffers, and ``reduced_bytes``
    holds the bytes of each kind it reduced (``grads``, ``logs``,
    ``buffers``).  None: this process's step alone."""

    def __init__(self, net: SoftGroupNet, cfg, caps,
                 optimizer: torch.optim.Optimizer, frozen_modules=(),
                 schedule: Callable[[int], float] | None = None,
                 clip_grad_norm: float | None = None, group=None):
        self.net, self.cfg, self.caps = net, cfg, caps
        self.optimizer = optimizer
        self.frozen = tuple(frozen_modules)
        self.schedule = schedule
        self.clip_grad_norm = clip_grad_norm
        self.group = group
        self.updates = 0
        self.grad_norm = None
        self.reduced_bytes = None

    def __call__(self, batch, generator: torch.Generator | None = None,
                 rand: torch.Tensor | None = None) -> dict:
        set_train_modes(self.net, self.frozen)
        self.optimizer.zero_grad(set_to_none=True)
        loss, log_vars = self.net.loss_forward(
            batch, self.cfg, self.caps, generator=generator, rand=rand)
        loss.backward()
        params = [p for g in self.optimizer.param_groups for p in g['params']]
        if self.group is not None:
            log_vars, self.reduced_bytes = average_step(
                params, self.net, log_vars, self.group)
        if self.clip_grad_norm:
            self.grad_norm = torch.nn.utils.clip_grad_norm_(
                params, self.clip_grad_norm)
        if self.schedule is not None:
            lr = self.schedule(self.updates)
            for group in self.optimizer.param_groups:
                group['lr'] = lr
        self.optimizer.step()
        self.updates += 1
        return {k: v.detach() for k, v in log_vars.items()}


class TrainState(NamedTuple):
    net: SoftGroupNet
    optimizer: torch.optim.Optimizer
    step: TrainStep


def set_train_modes(net: SoftGroupNet, frozen_modules) -> None:
    """Train mode everywhere but the batch norms of frozen backbone
    modules."""
    net.train()
    for name in frozen_modules:
        if name in BACKBONE_NORM_MODULES:
            getattr(net, name).eval()


def make_train_step(net: SoftGroupNet, cfg, caps,
                    optimizer: torch.optim.Optimizer, frozen_modules=(),
                    schedule=None, clip_grad_norm=None,
                    group=None) -> TrainStep:
    """The train step of ``net`` (see ``TrainStep``)."""
    return TrainStep(net, cfg, caps, optimizer, frozen_modules, schedule,
                     clip_grad_norm, group)
