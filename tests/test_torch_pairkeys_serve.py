"""Parity of the port's SoftGroup++ serving on int64 cell keys (the
``configs/softgroup_pp/`` S3DIS and STPLS3D yamls: ``with_pyramid``,
``lvl_fusion``, ``pair_keys`` left at its default) with the JAX reference
on the CPU: ``forward_grouping`` over the scene pyramid at levels 1, 2 and
3 on int64 keys, then ``run_eval`` end to end on each yaml's model section
at a narrow width (channels 8, 3 levels) over a 2-scan split written to a
temp dir, with the reference's weights (a seeded port init carried across
as a flax tree, the semantic head's bias lifted on three classes so that
they reach three pyramid levels).

Coordinates sit on the 1/64 grid after the test transform's fixed
rotation (a 3/64 grid where the classes take pyramid levels 2 and 3) and
the offset head is zeroed, so grouping is exact on both sides.  Tolerances: proposals, levels, instance masks and labels and AP
exact; confidences, mIoU, accuracy and offset MAE within 1e-4 (f32 heads
of two backends).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softgroup_tpu.data.padding import build_scene_batch as jax_batch
from softgroup_tpu.model.softgroup import Capacities as JCaps
from softgroup_tpu.model.softgroup import SoftGroupNet as JNet
from softgroup_tpu.model.softgroup import \
    forward_grouping as jax_forward_grouping
from softgroup_tpu.tools_impl.test_runner import run_eval as jax_run_eval
from softgroup_tpu_torch import entry
from softgroup_tpu_torch.data import build_dataloader, build_dataset
from softgroup_tpu_torch.data.padding import build_scene_batch
from softgroup_tpu_torch.data.synthetic import make_scene
from softgroup_tpu_torch.model.softgroup import (Capacities,
                                                 class_active_counts,
                                                 forward_grouping,
                                                 pyramid_levels)
from softgroup_tpu_torch.ops import grouping
from softgroup_tpu_torch.tools_impl import test_runner
from softgroup_tpu_torch.util.config import Config, load_config

from test_torch_plus import _pyramid_logits
from test_torch_train import _flax_tree
from torch_helpers import CAPS, PLUS, batch_args, tiny_cfg, tiny_data

torch.set_num_threads(1)
jrunner = importlib.import_module('softgroup_tpu.tools_impl.test_runner')

PAIR_PLUS = dict(PLUS, grouping_cfg={k: v for k, v in
                                     PLUS['grouping_cfg'].items()
                                     if k != 'pair_keys'})


def test_forward_grouping_plus_int64_levels(monkeypatch):
    """SoftGroup++ grouping on int64 cell keys at thresholds (20, 60):
    class 4 at level 1, class 3 at level 2 and class 2 at level 3 (its
    coordinates divided by 3), the same proposals as the reference's pair
    keys."""
    data = tiny_data()
    tb = build_scene_batch(*batch_args(data), Capacities(**CAPS),
                           num_levels=3, device='cpu')
    jb = jax_batch(*batch_args(data), JCaps(**CAPS), num_levels=3)
    cfg = tiny_cfg(dict(PAIR_PLUS, grouping_cfg=dict(
        PAIR_PLUS['grouping_cfg'], pyramid_thresholds=(20, 60))))
    assert 'pair_keys' not in cfg.grouping_cfg
    rng = np.random.RandomState(11)
    sem = _pyramid_logits(tb, rng)
    off = (rng.randint(-3, 4, (sem.shape[0], 3)) / 64).astype(np.float32)
    counts = class_active_counts(torch.from_numpy(sem),
                                 tb.pyramid.point_valid, cfg.grouping_cfg)
    live = counts >= cfg.test_cfg.min_npoint
    assert pyramid_levels(counts, cfg.grouping_cfg)[live].tolist() == [
        3.0, 2.0, 1.0]
    keys = []

    def join(*a, _f=grouping.cell_neighbor_join):
        keys.append(a[0].dtype)
        return _f(*a)
    monkeypatch.setattr(grouping, 'cell_neighbor_join', join)
    ref = jax_forward_grouping(
        jnp.asarray(sem), jnp.asarray(off), jb.batch_idxs, jb.coords_float,
        jb.pyramid.point_valid, cfg, JCaps(**CAPS))
    out = forward_grouping(torch.from_numpy(sem), torch.from_numpy(off),
                           tb.batch_idxs, tb.coords_float,
                           tb.pyramid.point_valid, cfg, Capacities(**CAPS))
    assert keys == [torch.int64]
    assert int(ref.n_proposals) >= 3
    for f in ('entry_pt', 'entry_seg', 'entry_valid', 'n_proposals',
              'prop_valid'):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# run_eval on the ++ S3DIS fold-5 and ++ STPLS3D yamls
# ---------------------------------------------------------------------------

# the yaml, its scans' classes and thing start, the scene's extent factor
# (S3DIS rooms of 3 m; STPLS3D tiles of 60 m: 1/3 m voxels), and the
# component-size factor of a 6000-point scan (the yaml's npoint_thr is a
# share of each class's mean size in a whole room or tile)
YAMLS = {
    's3dis': ('softgroup++_s3dis_fold5.yaml', 13, 2, 1, 0.1),
    'stpls3d': ('softgroup++_stpls3d.yaml', 15, 1, 20, 1.0),
}
LIFT = (2.5, 2.0)   # the semantic biases of classes 2 and 3
N_POINTS = 6000


def _write_scans(root, name, n_classes, thing_start, factor, step,
                 seed=5):
    """Two scenes as prepared ``_inst_nostuff.pth`` scans (labels float64)
    whose coordinates, after the test transform's fixed 0.35 pi rotation,
    sit on a grid of ``step`` / 64: ``make_scene`` blobs in a 3 m room,
    scaled by ``factor``.  The grid is coarser than a voxel, so a level-0
    voxel's mean is one grid point; at step 3 it stays on the 1/64 grid at
    pyramid levels 2 and 3 (divided by 2 or 3).  So the f32 centroid sums
    of the reference are exact and both sides gate on the same
    centroids."""
    rng = np.random.RandomState(seed)
    theta = 0.35 * np.pi
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    root.mkdir(parents=True, exist_ok=True)
    for i in range(2):
        xyz, rgb, sem, inst = make_scene(
            rng, n_points=N_POINTS, n_instances=8, room=3.0,
            semantic_classes=n_classes, thing_start=thing_start)
        xyz = (np.round(xyz.astype(np.float64) * 64 / step) * step / 64
               * factor + 0.75) @ rot.T
        torch.save((xyz, rgb, sem.astype(np.float64),
                    inst.astype(np.float64)),
                   str(root / f'{name}{i}_inst_nostuff.pth'))


def _narrow(kind, tmp_path, pyramid):
    """The yaml at channels 8, 3 levels, its test split under
    ``tmp_path``; the net of its model section with the reference's
    weights.  A random init's semantic head is nearly constant over the
    voxels, so the two lifted classes are active on every voxel of a scan:
    ``pyramid`` sets the thresholds just under the two scans' voxel counts
    (the smaller scan's classes take level 2, the larger's level 3), else
    the yaml's (1e5, 1e6) leave every class at level 1."""
    name, n_cls, thing_start, factor, thr_scale = YAMLS[kind]
    cfg = load_config(f'{entry.CONFIGS}/softgroup_pp/{name}')
    # S3DIS reads <data_root>/<prefix>*, the others <data_root>/<prefix>/*
    step = 3 if pyramid else 1
    if kind == 's3dis':
        _write_scans(tmp_path, f'{cfg.data.test.prefix}_scan', n_cls,
                     thing_start, factor, step)
    else:
        _write_scans(tmp_path / cfg.data.test.prefix, 'scan', n_cls,
                     thing_start, factor, step)
    cfg.data.test.data_root = str(tmp_path)
    cfg.dataloader.test.num_workers = 0
    m = cfg.model
    m.channels, m.num_blocks = 8, 3
    m.grouping_cfg.npoint_thr *= thr_scale
    assert 'pair_keys' not in m.grouping_cfg
    assert m.grouping_cfg.with_pyramid and m.test_cfg.lvl_fusion
    net = entry.build_net(m, seed=3, device='cpu', bf16=False)
    with torch.no_grad():
        net.offset_linear.final_kernel.zero_()
        net.offset_linear.final_bias.zero_()
        net.semantic_linear.final_bias[2:4] = torch.tensor(LIFT)
        for name_, buf in net.named_buffers():   # off their init values
            buf.add_(torch.rand(buf.shape, generator=torch.Generator()
                                .manual_seed(len(name_))) * 0.1)
    caps = Capacities(**dict(CAPS, proposals=32, instances=32))
    if pyramid:
        runner = test_runner.InferenceRunner(net, m, caps, 3, device='cpu')
        counts = []
        for data in build_dataloader(build_dataset(cfg.data.test),
                                     training=False):
            batch, _ = runner.build_batch(data)
            valid = batch.pyramid.levels[0].vox_valid
            with torch.no_grad():
                sem_v = net.backbone_voxel_heads(batch.vox_in,
                                                 batch.pyramid)[0]
            c = class_active_counts(sem_v, valid, m.grouping_cfg).tolist()
            assert c[2] == c[3] == int(valid.sum()), c
            counts.append(c[2])
        lo, hi = sorted(counts)
        assert m.test_cfg.min_npoint <= lo < hi, counts
        m.grouping_cfg.pyramid_thresholds = [lo - 1, hi - 1]
    return cfg, net, caps


class Levels:
    """The per-class pyramid levels of each forward of ``net``."""

    def __init__(self, net, gcfg):
        self.gcfg, self.seen = gcfg, []
        self.hook = net.semantic_linear.register_forward_hook(
            lambda mod, a, out: self.seen.append((out, a[1])))

    def levels(self):
        self.hook.remove()
        return [pyramid_levels(class_active_counts(o, v, self.gcfg),
                               self.gcfg).tolist() for o, v in self.seen]


def _instance_sets(instances):
    return sorted((d['scan_id'], d['label_id'], d['pred_mask']['counts'],
                   d['conf']) for d in instances)


@pytest.mark.parametrize('pyramid', [False, True],
                         ids=['level1', 'levels23'])
@pytest.mark.parametrize('kind', list(YAMLS))
def test_run_eval_plus_pair_keys_matches(kind, pyramid, tmp_path,
                                         monkeypatch):
    """``run_eval`` of the ++ yaml on two scans: the reference's instances
    (masks and labels exact, confidences within 1e-4), AP / AP_50 / AP_25
    equal, mIoU, Acc and Offset_MAE within 1e-4; the lifted classes at
    pyramid level 1 in both scans, or at levels 2 and 3; every cell join
    on int64 keys."""
    cfg, net, caps = _narrow(kind, tmp_path, pyramid)
    jnet = JNet(channels=8, num_blocks=3,
                semantic_classes=cfg.model.semantic_classes,
                instance_classes=cfg.model.instance_classes, bf16=False)
    variables = _flax_tree(net)
    kept, keys = {}, []

    def keep(side, mod):
        def summarize(results, *a, _f=mod.summarize, **kw):
            kept[side] = results
            return _f(results, *a, **kw)
        monkeypatch.setattr(mod, 'summarize', summarize)
    keep('ref', jrunner)
    keep('port', test_runner)

    def join(*a, _f=grouping.cell_neighbor_join):
        keys.append(a[0].dtype)
        return _f(*a)
    monkeypatch.setattr(grouping, 'cell_neighbor_join', join)
    want = jax_run_eval(jnet, variables, cfg, JCaps(**caps._asdict()), 3)
    lv = Levels(net, cfg.model.grouping_cfg)
    stats = []
    got = test_runner.run_eval(net, cfg, caps, 3, device='cpu',
                               scene_stats=stats)
    levels = lv.levels()
    assert keys == [torch.int64] * 2
    taken = sorted({lv[c] for lv in levels for c in (2, 3)})
    assert taken == ([2.0, 3.0] if pyramid else [1.0]), levels
    assert sorted(got) == sorted(want) == sorted(
        ['AP', 'AP_50', 'AP_25', 'mIoU', 'Acc', 'Offset_MAE'])
    for k in ('AP', 'AP_50', 'AP_25'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ('mIoU', 'Acc', 'Offset_MAE'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert len(stats) == 2 and all(s['n_proposals'] > 0 for s in stats)
    mine = _instance_sets([d for r in kept['port']
                           for d in r['pred_instances']])
    theirs = _instance_sets([d for r in kept['ref']
                             for d in r['pred_instances']])
    assert len(mine) == len(theirs) > 0
    assert [m[:3] for m in mine] == [t[:3] for t in theirs]
    np.testing.assert_allclose([m[3] for m in mine], [t[3] for t in theirs],
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(kept['port'], kept['ref']):
        np.testing.assert_array_equal(a['semantic_preds'],
                                      b['semantic_preds'])
        np.testing.assert_array_equal(a['gt_instances'], b['gt_instances'])
