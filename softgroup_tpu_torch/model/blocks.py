"""Network building blocks over the sparse-conv ops (counterpart of
``softgroup_tpu/model/blocks.py``).

Modules work on padded (V, C) feature matrices plus a ``LevelGeom``.
Parameter and buffer names follow the reference's flax tree (``kernel``,
``scale``/``bias``/``mean``/``var``, ``hidden0_kernel``, ``block0``, ``u``,
...), so ``util/convert.py`` maps a flax tree onto a state dict by joining
the path.  ``MaskedBatchNorm`` follows the module's mode: in train mode it
normalizes with the statistics of the rows its ``mask`` marks valid and
updates its running statistics; in eval mode it uses the running ones.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.conv_kernel import keyed_conv
from ..ops.geometry import LevelGeom
from ..ops.norm_kernel import masked_batch_norm
from ..ops.sparse_conv import down_conv, inverse_conv, linear, subm_conv
from ..util.trace import traced


def _uniform(shape, bound, generator):
    return nn.Parameter(
        (torch.rand(shape, generator=generator) * 2 - 1) * bound)


def _fan_in_uniform(shape, generator):
    """flax variance_scaling(1/3, 'fan_in', 'uniform'): bound 1/sqrt(fan_in),
    fan_in = product of all but the last dim."""
    return _uniform(shape, 1.0 / math.sqrt(math.prod(shape[:-1])), generator)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid rows (torch semantics: eps=1e-4,
    momentum=0.1; the biased batch variance normalizes, the unbiased one
    updates the running variance, with the reference's max(n - 1, 1)
    guard).  The result is computed in f32 and returned in the input's
    dtype; statistics are f32.  ``relu`` applies the ReLU that follows
    every call site (fused into the kernels on the card:
    ``ops/norm_kernel.py``)."""

    def __init__(self, features: int, eps: float = 1e-4,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))

    @traced('bn')
    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                relu: bool = False) -> torch.Tensor:
        if self.training and mask is None:
            raise ValueError('MaskedBatchNorm: train mode needs the row mask')
        return masked_batch_norm(x, mask, self.scale, self.bias, self.mean,
                                 self.var, self.training, self.eps,
                                 self.momentum, relu)


class Dense(nn.Module):
    """nn.Linear with the reference's init: kernel (Cin, Cout)."""

    def __init__(self, cin: int, features: int, generator=None):
        super().__init__()
        self.kernel = _fan_in_uniform((cin, features), generator)
        self.bias = _uniform((features,), 1.0 / math.sqrt(cin), generator)

    def forward(self, x):
        return linear(x, self.kernel, self.bias)


class SubMConv(nn.Module):
    """3^3 submanifold conv, kernel (27, Cin, Cout), no bias.  A level with
    a rulebook runs K1 on its row order (``geometry.row_ordered``); a keyed
    level (``ckey``) runs K4."""

    def __init__(self, cin: int, features: int, generator=None):
        super().__init__()
        self.kernel = _fan_in_uniform((27, cin, features), generator)

    def forward(self, x, lv: LevelGeom):
        if lv.subm_rules is None:
            return keyed_conv(x, self.kernel, lv.ckey, lv.ckey,
                              lv.spatial_d, strided=False)
        return subm_conv(x, self.kernel, lv.subm_rules, lv.subm_rows,
                         lv.subm_grouped)


class DownConv(nn.Module):
    """k=2 s=2 strided conv, kernel (8, Cin, Cout)."""

    def __init__(self, cin: int, features: int, generator=None):
        super().__init__()
        self.kernel = _fan_in_uniform((8, cin, features), generator)

    def forward(self, x, lv: LevelGeom, nxt: LevelGeom):
        if lv.down_rules is None:
            return keyed_conv(x, self.kernel, nxt.ckey, lv.ckey,
                              nxt.spatial_d, strided=True)
        return down_conv(x, self.kernel, lv.down_rules)


class UpConv(nn.Module):
    """k=2 inverse conv, kernel (8, Cin, Cout)."""

    def __init__(self, cin: int, features: int, generator=None):
        super().__init__()
        self.kernel = _fan_in_uniform((8, cin, features), generator)

    def forward(self, x, parent_idx, child_tap, down_rules=None):
        return inverse_conv(x, self.kernel, parent_idx, child_tap,
                            down_rules)


class MLP(nn.Module):
    """(num_layers-1) x [Linear -> BN? -> ReLU] -> Linear; xavier-uniform
    hidden kernels, N(0, 0.01) final kernel, zero biases."""

    def __init__(self, cin: int, out_features: int, norm: bool = True,
                 num_layers: int = 2, generator=None):
        super().__init__()
        self.num_layers = num_layers
        self.norm = norm
        bound = math.sqrt(6.0 / (cin + cin))
        for i in range(num_layers - 1):
            self.register_parameter(f'hidden{i}_kernel',
                                    _uniform((cin, cin), bound, generator))
            self.register_parameter(f'hidden{i}_bias',
                                    nn.Parameter(torch.zeros(cin)))
            if norm:
                self.add_module(f'norm{i}', MaskedBatchNorm(cin))
        self.final_kernel = nn.Parameter(
            torch.randn((cin, out_features), generator=generator) * 0.01)
        self.final_bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x, mask=None):
        for i in range(self.num_layers - 1):
            x = linear(x, getattr(self, f'hidden{i}_kernel'),
                       getattr(self, f'hidden{i}_bias'))
            if self.norm:
                x = getattr(self, f'norm{i}')(x, mask, relu=True)
            else:
                x = torch.relu(x)
        return linear(x, self.final_kernel, self.final_bias)


class ResidualBlock(nn.Module):
    """Pre-activation sparse residual block: identity (1x1 when channels
    change) + [BN-ReLU-SubM-BN-ReLU-SubM]."""

    def __init__(self, cin: int, features: int, generator=None):
        super().__init__()
        if cin != features:
            self.i_branch_kernel = _fan_in_uniform((cin, features), generator)
        else:
            self.i_branch_kernel = None
        self.norm1 = MaskedBatchNorm(cin)
        self.conv1 = SubMConv(cin, features, generator)
        self.norm2 = MaskedBatchNorm(features)
        self.conv2 = SubMConv(features, features, generator)

    def forward(self, x, lv: LevelGeom):
        identity = x if self.i_branch_kernel is None \
            else linear(x, self.i_branch_kernel)
        y = self.conv1(self.norm1(x, lv.vox_valid, relu=True), lv)
        y = self.conv2(self.norm2(y, lv.vox_valid, relu=True), lv)
        return y + identity


class UBlock(nn.Module):
    """Recursive sparse U-Net.  n_planes[i] is the width at pyramid level i:
    block_reps residual blocks, k2s2 down, recurse, inverse-conv up, concat
    skip, block_reps tail blocks (the first tail block sees 2x channels)."""

    def __init__(self, n_planes: Sequence[int], block_reps: int = 2,
                 cin: int | None = None, generator=None):
        super().__init__()
        width = n_planes[0]
        cin = width if cin is None else cin
        self.block_reps = block_reps
        self.deep = len(n_planes) > 1
        for i in range(block_reps):
            self.add_module(f'block{i}', ResidualBlock(
                cin if i == 0 else width, width, generator))
        if self.deep:
            nxt = n_planes[1]
            self.conv_norm = MaskedBatchNorm(width)
            self.conv = DownConv(width, nxt, generator)
            self.u = UBlock(n_planes[1:], block_reps, generator=generator)
            self.deconv_norm = MaskedBatchNorm(nxt)
            self.deconv = UpConv(nxt, width, generator)
            for i in range(block_reps):
                self.add_module(f'block_tail{i}', ResidualBlock(
                    2 * width if i == 0 else width, width, generator))

    def forward(self, x, levels: Sequence[LevelGeom]):
        lv = levels[0]
        for i in range(self.block_reps):
            x = getattr(self, f'block{i}')(x, lv)
        if self.deep:
            nxt = levels[1]
            y = self.conv(self.conv_norm(x, lv.vox_valid, relu=True), lv,
                          nxt)
            y = self.u(y, levels[1:])
            y = self.deconv_norm(y, nxt.vox_valid, relu=True)
            y = self.deconv(y, lv.parent_idx, lv.child_tap, lv.down_rules)
            x = torch.cat([x, y], dim=1)
            for i in range(self.block_reps):
                x = getattr(self, f'block_tail{i}')(x, lv)
        return x
