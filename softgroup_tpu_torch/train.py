"""One-device train step (counterpart of ``softgroup_tpu/parallel/mesh.py``
``TrainState`` / ``make_train_step`` without a mesh): ``loss_forward`` ->
``backward`` -> optimizer step.

Frozen modules keep ``requires_grad`` False (no gradient is computed for
them, as the reference leaves them out of ``value_and_grad``), and the
batch norms of frozen backbone modules stay in eval mode (the reference's
``SoftGroupNet._t``); everything else trains.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .model.softgroup import SoftGroupNet

# the modules whose batch norms the reference switches by ``_t``
BACKBONE_NORM_MODULES = ('unet', 'output_norm', 'semantic_linear',
                         'offset_linear')


class TrainState(NamedTuple):
    net: SoftGroupNet
    optimizer: torch.optim.Optimizer
    step: Callable          # step(batch, generator=None, rand=None)


def set_train_modes(net: SoftGroupNet, frozen_modules) -> None:
    """Train mode everywhere but the batch norms of frozen backbone
    modules."""
    net.train()
    for name in frozen_modules:
        if name in BACKBONE_NORM_MODULES:
            getattr(net, name).eval()


def make_train_step(net: SoftGroupNet, cfg, caps,
                    optimizer: torch.optim.Optimizer, frozen_modules=()):
    """``step(batch, generator=None, rand=None) -> log_vars`` (detached
    tensors on the batch's device).  ``rand``: the (2, 3) numbers of the
    random quantization, else drawn from ``generator``."""
    frozen = tuple(frozen_modules)

    def step(batch, generator: torch.Generator | None = None,
             rand: torch.Tensor | None = None) -> dict:
        set_train_modes(net, frozen)
        optimizer.zero_grad(set_to_none=True)
        loss, log_vars = net.loss_forward(batch, cfg, caps,
                                          generator=generator, rand=rand)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in log_vars.items()}

    return step
