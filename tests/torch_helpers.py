"""Shared inputs of the PyTorch-port parity tests: the tiny SoftGroup config
of tests/test_model.py with ``pair_keys=False``, and one numpy scene batch
made from a seed.  Coordinates are multiples of 1/64 so every f32 cumsum of
the grouping centroids is exact in any summation order."""

from __future__ import annotations

import numpy as np

from softgroup_tpu_torch.data.synthetic import collate_scenes, make_scene
from softgroup_tpu_torch.util.config import Config

TINY = dict(
    channels=8,
    num_blocks=3,
    semantic_classes=6,
    instance_classes=4,
    semantic_only=False,
    ignore_label=-100,
    with_coords=True,
    sem2ins_classes=[],
    grouping_cfg=dict(score_thr=0.1, radius=0.3, mean_active=300,
                      class_numpoint_mean=[-1.0] * 6, npoint_thr=10,
                      ignore_classes=[0, 1], pair_keys=False),
    instance_voxel_cfg=dict(scale=10, spatial_shape=10),
    train_cfg=dict(max_proposal_num=32, pos_iou_thr=0.5),
    test_cfg=dict(x4_split=False, cls_score_thr=0.001, mask_score_thr=-0.5,
                  min_npoint=10, eval_tasks=['semantic', 'instance']),
)

# the 20-class flagship head at a tiny width: score_thr 0.2 takes the
# per-point top-k branch of forward_grouping
TINY20 = dict(TINY, semantic_classes=20, instance_classes=18,
              grouping_cfg=dict(TINY['grouping_cfg'], score_thr=0.2,
                                class_numpoint_mean=[-1.0] * 20))

CAPS = dict(points=4096, voxels=(2048, 1024, 512), grouping_points=8192,
            proposals=32, proposal_entries=8192, instances=32,
            inst_voxels=(2048, 512), grouping_cells=4096)


def tiny_cfg(d=TINY) -> Config:
    return Config(d)


def tiny_data(seed: int = 1) -> dict:
    """Collated numpy data of two small scenes, coordinates on a 1/64 grid."""
    rng = np.random.RandomState(seed)
    scenes = []
    for _ in range(2):
        xyz, rgb, sem, inst = make_scene(rng, n_points=1500, n_instances=4,
                                         room=3.0, semantic_classes=6)
        xyz = (np.round(xyz * 64) / 64).astype(np.float32)
        scenes.append((xyz, rgb, sem, inst))
    return collate_scenes(scenes, scale=10.0)


def batch_args(data: dict) -> tuple:
    return (data['coords'], data['coords_float'], data['feats'],
            data['semantic_labels'], data['instance_labels'],
            data['pt_offset_labels'], data['instance_pointnum'],
            data['instance_cls'], data['spatial_shape'])


def logits_clear_of(rng, p: int, n_cls: int, thr: float,
                    margin: float = 1e-3) -> np.ndarray:
    """(p, n_cls) f32 logits whose softmax stays ``margin`` away from
    ``thr``, so a last-bit difference between two softmax implementations
    cannot flip a threshold decision."""
    out = np.empty((p, n_cls), np.float32)
    todo = np.arange(p)
    while len(todo):
        lg = (rng.randn(len(todo), n_cls) * 2.0).astype(np.float32)
        e = np.exp(lg.astype(np.float64) - lg.max(1, keepdims=True))
        sm = e / e.sum(1, keepdims=True)
        ok = (np.abs(sm - thr) > margin).all(1)
        out[todo[ok]] = lg[ok]
        todo = todo[~ok]
    return out
