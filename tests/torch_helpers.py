"""Shared inputs of the PyTorch-port parity tests: the tiny SoftGroup config
of tests/test_model.py with ``pair_keys=False`` (and its SoftGroup++ form),
and one numpy scene batch made from a seed.  Coordinates are multiples of 1/64 so every f32 cumsum of
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

# the tiny config as SoftGroup++: scene-pyramid grouping and lvl_fusion;
# thresholds low enough that a random init's classes (~2000 active voxels
# each on tiny_data) take level 3
PLUS = dict(TINY, grouping_cfg=dict(TINY['grouping_cfg'], with_pyramid=True,
                                    pyramid_thresholds=(100, 1000)),
            test_cfg=dict(TINY['test_cfg'], lvl_fusion=True))

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


def batch_arrays(tb, jb):
    """(name, port array, reference array) of every batch field."""
    yield 'p2v', tb.pyramid.p2v, jb.pyramid.p2v
    yield 'point_valid', tb.pyramid.point_valid, jb.pyramid.point_valid
    for i, (lv, jlv) in enumerate(zip(tb.pyramid.levels, jb.pyramid.levels)):
        for f in ('vox_coords', 'vox_valid', 'subm_rules', 'down_rules',
                  'parent_idx', 'child_tap', 'dims'):
            a, b = getattr(lv, f), getattr(jlv, f)
            assert (a is None) == (b is None), (i, f)
            if a is not None:
                yield f'{i}.{f}', a, b
    for f in ('feats', 'coords_float', 'batch_idxs', 'semantic_labels',
              'instance_labels', 'pt_offset_labels', 'instance_pointnum',
              'instance_cls', 'instance_valid', 'vox_in', 'point_perm'):
        yield f, getattr(tb, f), getattr(jb, f)


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


def jax_tiny_model(jb, cfg, caps):
    """The reference's tiny net (bf16 off) and its variables, initialised
    on the reference batch ``jb``: a zero offset head keeps the shifted
    points on the 1/64 grid, so the grouping centroids are exact on both
    sides, and the running stats are pushed off their init values so the
    eval-mode BN is exercised."""
    import jax

    from softgroup_tpu.model.softgroup import SoftGroupNet as JNet
    net = JNet(channels=cfg.channels, num_blocks=cfg.num_blocks,
               semantic_classes=cfg.semantic_classes,
               instance_classes=cfg.instance_classes, bf16=False)
    variables = jax.jit(lambda key, b: net.init(
        key, b, cfg, caps, method=net.test_forward))(
            jax.random.PRNGKey(0), jb)
    variables = jax.tree.map(np.array, variables)   # writable copies
    rng = np.random.RandomState(2)
    params = variables['params']
    params['offset_linear']['final_kernel'][:] = 0
    params['offset_linear']['final_bias'][:] = 0
    stats = jax.tree.map(
        lambda a: (a + rng.rand(*a.shape).astype(np.float32) * 0.1),
        variables['batch_stats'])
    return net, dict(params=params, batch_stats=stats)
