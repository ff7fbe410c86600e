"""The plain reference against the program's plain CPU path at tiny
sizes: with the program in float32 the two agree to rounding (they share
no code: the reference builds its own voxels, neighbours, proposals and
grids)."""

from __future__ import annotations

import torch

from conftest import SERVE, TRAIN, run_cell, tiny_serve, tiny_train

CPU = torch.device('cpu')


def test_train_steps_match_the_f32_program():
    conf, tr = tiny_train()
    conf['run']['tpu']['bf16'] = False
    res, _ = run_cell(TRAIN, conf, tr, CPU)
    n = res.numbers
    assert n['loss_gap1'] < 1e-5
    assert n['grad_gap'] < 1e-4
    assert n['grad_gap_median'] < 1e-5


def test_serving_matches_the_f32_program_exactly():
    conf, tr = tiny_serve()
    conf['run']['tpu']['bf16'] = False
    res, _ = run_cell(SERVE, conf, tr, CPU, seconds=0.1)
    n = res.numbers
    assert n['n_proposals'] > 0
    for k in ('semantic_gap', 'offset_gap', 'proposal_mismatch', 'cls_gap',
              'iou_gap', 'mask_gap'):
        assert n[k] < 1e-5, (k, n)


def test_serving_matches_with_capped_grids():
    """Proposal grids past the voxel caps: the reference drops the same
    voxels and reads the same clamped rows."""
    conf, tr = tiny_serve()
    conf['run']['tpu']['bf16'] = False
    conf['run']['tpu']['caps']['inst_voxels'] = [1024, 256]
    res, _ = run_cell(SERVE, conf, tr, CPU, seconds=0.1)
    for k in ('proposal_mismatch', 'cls_gap', 'iou_gap', 'mask_gap'):
        assert res.numbers[k] < 1e-5, (k, res.numbers)
