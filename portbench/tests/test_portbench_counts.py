"""The yardstick's arithmetic against hand counts at tiny shapes."""

from __future__ import annotations

import pytest
import torch

from portbench import flops, roofline


def _rules():
    # 3 taps over 4 output rows: 5 valid hits
    return torch.tensor([[0, -1, 2, -1], [1, 1, -1, -1], [-1, -1, -1, 3]],
                        dtype=torch.int32)


def test_k1_bytes_and_flops():
    feats = torch.zeros((6, 8), dtype=torch.bfloat16)
    weight = torch.zeros((3, 8, 16))
    c = roofline.finish(roofline.k1_call(feats, weight, _rules()),
                        lambda r: int((r >= 0).sum()))
    # feats 6*8*2, weight 3*8*16*2 (bf16), rules 3*4*4, out 4*16*2
    assert c['bytes'] == 96 + 768 + 48 + 128
    assert c['flops'] == 2 * 5 * 8 * 16
    assert c['dtype'] == 'bfloat16'


def test_k5_bytes_and_flops():
    feats = torch.zeros((6, 8), dtype=torch.bfloat16)
    g = torch.zeros((4, 16), dtype=torch.float32)
    c = roofline.finish(roofline.k5_call(feats, g, _rules()),
                        lambda r: int((r >= 0).sum()))
    # feats 6*8*2, g in feats' type 4*16*2, rules 48, out 3*8*16*4 (f32)
    assert c['bytes'] == 96 + 128 + 48 + 1536
    assert c['flops'] == 2 * 5 * 8 * 16


def test_linear_flops():
    # a point head's linear layer over 10 points: 2 x rows x Cin x Cout
    assert flops.layer_flops('semantic_linear.final_kernel', (4, 3),
                             hits=[], voxels=[], points=10) == 2 * 10 * 4 * 3


def test_bound_takes_the_larger_side():
    mem = dict(bytes=3.35e12, flops=1.0, dtype='bfloat16')
    ops = dict(bytes=1.0, flops=989e12, dtype='bfloat16')
    assert roofline.bound_s(mem) == pytest.approx(1.0)
    assert roofline.bound_s(ops) == pytest.approx(1.0)


def test_backbone_flops_by_hand():
    shapes = {
        'input_conv.kernel': (27, 6, 32),
        'unet.block0.conv1.kernel': (27, 32, 32),
        'unet.block0.norm1.scale': (32,),
        'unet.conv.kernel': (8, 32, 64),
        'unet.u.block0.conv1.kernel': (27, 64, 64),
        'unet.deconv.kernel': (8, 64, 32),
        'unet.block_tail0.i_branch_kernel': (64, 32),
        'semantic_linear.hidden0_kernel': (32, 32),
        'semantic_linear.final_kernel': (32, 20),
    }
    hits, voxels, points = [100, 30], [20, 8], 50
    fwd = (2 * 100 * 6 * 32 + 2 * 100 * 32 * 32 + 2 * 20 * 32 * 64
           + 2 * 30 * 64 * 64 + 2 * 20 * 64 * 32 + 2 * 20 * 64 * 32
           + 2 * 50 * 32 * 32 + 2 * 50 * 32 * 20)
    assert flops.backbone_flops(shapes, hits, voxels, points,
                                train=False) == fwd
    # training: 3x every trained layer, 2x the input conv (no input grad)
    assert flops.backbone_flops(shapes, hits, voxels, points) == \
        3 * fwd - 2 * 100 * 6 * 32
    # a frozen layer counts its forward alone
    frozen = flops.backbone_flops(
        shapes, hits, voxels, points,
        trained=lambda n: not n.startswith('semantic_linear'))
    head = 2 * 50 * 32 * 32 + 2 * 50 * 32 * 20
    assert frozen == 3 * fwd - 2 * 100 * 6 * 32 - 2 * head
