"""Seeded weights, made by the benchmark on the device and handed alike to
the program (``load_state_dict``) and to the reference.

The leaves follow the SoftGroup initialisers by name: conv, 1x1 and dense
kernels uniform in +-1/sqrt(fan_in) (fan_in: all but the last dim), MLP
hidden kernels Xavier-uniform, final MLP kernels N(0, 0.01), a dense
layer's bias uniform in +-1/sqrt(its fan_in), other biases 0, batch-norm
scales and running variances 1, running means 0.  All uniform leaves come
from one draw and all normal leaves from another, on one generator seeded
with the run's seed.
"""

from __future__ import annotations

import math

import torch

NORM_LEAVES = ('scale', 'bias', 'mean', 'var')


def _is_norm(name: str) -> bool:
    *mods, leaf = name.split('.')
    return leaf in NORM_LEAVES and bool(mods) and 'norm' in mods[-1]


def _rule(name: str, shape, shapes: dict):
    """('uniform', bound) | ('normal', std) | ('const', value)."""
    leaf = name.split('.')[-1]
    if _is_norm(name):
        return ('const', 1.0 if leaf in ('scale', 'var') else 0.0)
    if leaf.startswith('hidden') and leaf.endswith('_kernel'):
        return ('uniform', math.sqrt(6.0 / (2 * shape[0])))
    if leaf == 'final_kernel':
        return ('normal', 0.01)
    if leaf.endswith('kernel'):
        return ('uniform', 1.0 / math.sqrt(math.prod(shape[:-1])))
    if leaf == 'bias':
        kernel = name[:-len('bias')] + 'kernel'
        if kernel in shapes:      # a dense layer's own bias
            return ('uniform', 1.0 / math.sqrt(shapes[kernel][0]))
        return ('const', 0.0)
    if leaf.endswith('_bias'):
        return ('const', 0.0)
    raise ValueError(f'no initialiser for leaf {name}')


def make(shapes: dict, seed: int, device, lift: dict | None = None) -> dict:
    """{name: f32 tensor on ``device``} for ``shapes`` ({name: shape}, in
    state-dict order).  ``lift``: {"leaf", "classes", "value"} sets those
    entries of a leaf (the semantic bias that gives grouping work under a
    random init)."""
    rules = {n: _rule(n, s, shapes) for n, s in shapes.items()}
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    sizes = {kind: sum(math.prod(shapes[n]) for n, r in rules.items()
                       if r[0] == kind) for kind in ('uniform', 'normal')}
    draws = {
        'uniform': torch.rand(sizes['uniform'], generator=gen,
                              device=device) * 2 - 1,
        'normal': torch.randn(sizes['normal'], generator=gen,
                              device=device)}
    used = {'uniform': 0, 'normal': 0}
    out = {}
    for name, (kind, value) in rules.items():
        shape = tuple(shapes[name])
        if kind == 'const':
            out[name] = torch.full(shape, value, device=device)
            continue
        n = math.prod(shape)
        out[name] = (draws[kind][used[kind]:used[kind] + n]
                     .reshape(shape) * value)
        used[kind] += n
    if lift:
        out[lift['leaf']][list(lift['classes'])] = float(lift['value'])
    return out
