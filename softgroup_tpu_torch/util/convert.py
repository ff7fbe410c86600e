"""Carry weights across from the JAX package.

``from_jax_variables`` maps a flax variable tree ``{'params': ...,
'batch_stats': ...}`` (numpy leaves) onto the port's state dict.  The
port's modules carry the reference's names (``input_conv/kernel``,
``unet/block0/norm1/scale``, ``unet/u/...``,
``semantic_linear/hidden0_kernel``, ``batch_stats/.../mean|var``), so a
leaf's key is its path joined by dots in either collection; layouts are the
same ((K, Cin, Cout) conv kernels, (Cin, Cout) dense kernels).
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, 'items'):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield '.'.join(prefix), tree


def from_jax_variables(variables_np) -> dict:
    """Flax variables (numpy or array leaves) -> a state dict of f32 CPU
    tensors for ``SoftGroupNet.load_state_dict``."""
    state = {}
    for coll in ('params', 'batch_stats'):
        for key, leaf in _flatten(variables_np.get(coll, {})):
            if key in state:
                raise ValueError(f'duplicate key {key}')
            state[key] = torch.from_numpy(
                np.array(leaf, dtype=np.float32, copy=True))
    return state
