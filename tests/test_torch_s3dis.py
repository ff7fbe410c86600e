"""Parity of the port's S3DIS serving and evaluation slice with the JAX
reference on the CPU: pair-key grouping on int64 cell keys (the
reference's pairs of int32 keys), the datasets with the x4_split protocol,
the test loader, the evaluators, and ``run_eval`` end to end.

Grouping inputs keep coordinates on a 1/64 grid, so every f32 cumsum of the
reference's centroids is exact and both sides gate on the same centroids.
Tolerances: integer outputs, proposal sets, dataset arrays and instance AP
exact; mIoU, accuracy and offset MAE within 1e-4 (f32 offsets from two
backends).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softgroup_tpu.data import build_dataloader as jax_build_dataloader
from softgroup_tpu.data import build_dataset as jax_build_dataset
from softgroup_tpu.data.custom import CustomDataset as JCustomDataset
from softgroup_tpu.data.padding import build_scene_batch as jax_batch
from softgroup_tpu.data.s3dis import S3DISDataset as JS3DISDataset
from softgroup_tpu.evaluation.instance_eval import ScanNetEval as JScanNetEval
from softgroup_tpu.evaluation.point_wise_eval import (
    evaluate_offset_mae as jax_offset_mae,
    evaluate_semantic_acc as jax_semantic_acc,
    evaluate_semantic_miou as jax_semantic_miou)
from softgroup_tpu.model.softgroup import Capacities as JCaps
from softgroup_tpu.model.softgroup import \
    forward_grouping as jax_forward_grouping
from softgroup_tpu.tools_impl.test_runner import run_eval as jax_run_eval
from softgroup_tpu.util.config import load_config as jax_load_config
from softgroup_tpu_torch import entry
from softgroup_tpu_torch.data import (S3DISDataset, build_dataloader,
                                      build_dataset)
from softgroup_tpu_torch.data import transforms
from softgroup_tpu_torch.data.custom import CustomDataset
from softgroup_tpu_torch.data.padding import build_scene_batch
from softgroup_tpu_torch.data.synthetic import make_room_scene, make_scene
from softgroup_tpu_torch.evaluation.instance_eval import ScanNetEval
from softgroup_tpu_torch.evaluation.point_wise_eval import (
    evaluate_offset_mae, evaluate_semantic_acc, evaluate_semantic_miou)
from softgroup_tpu_torch.model.softgroup import (Capacities, SoftGroupNet,
                                                 forward_grouping)
from softgroup_tpu_torch.ops import grouping as grp
from softgroup_tpu_torch.ops.join_kernel import cell_neighbor_join_plain
from softgroup_tpu_torch.tools_impl.test_runner import run_eval
from softgroup_tpu_torch.util.config import Config
from softgroup_tpu_torch.util.convert import from_jax_variables
from softgroup_tpu_torch.util.rle import rle_encode

from torch_helpers import (CAPS, TINY, batch_args, jax_tiny_model,
                           logits_clear_of, tiny_cfg, tiny_data)

torch.set_num_threads(1)
jgrp = importlib.import_module('softgroup_tpu.ops.grouping')
jtransforms = importlib.import_module('softgroup_tpu.data.transforms')
RADIUS = 0.04
N_GROUPS = 13


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _entries(extent, n, seed):
    """``n`` grouping entries in 40 blobs over ``extent`` metres, on a
    1/64 grid, in 13 groups (one S3DIS request's classes), 5% invalid."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(40, 3) * extent
    pts = centers[rng.randint(0, 40, n)] + rng.randn(n, 3) * 0.03
    pts = (np.round(pts * 64) / 64).astype(np.float32)
    group = rng.randint(0, N_GROUPS, n).astype(np.int32)
    valid = rng.rand(n) < 0.95
    payload = rng.permutation(n).astype(np.int32)
    return pts, group, valid, payload


def _grid_cells(pts, valid):
    """d0 * d1 * d2 of the grouping's cell grid (cell size = radius)."""
    s = np.float32(RADIUS)
    mn = pts[valid].min(0)
    cell = np.floor((pts - mn) / s).astype(np.int64)
    dims = cell[valid].max(0) + 2
    return int(np.prod(dims))


@functools.lru_cache(maxsize=None)
def _jax_csr(m_cap):
    return jax.jit(functools.partial(
        jgrp.cell_cluster_csr, radius=RADIUS, cell_scale=1.0, m_cap=m_cap,
        pair_keys=True))


EXTENTS = {'room': ((6.0, 6.0, 3.0), 4096),
           'int32 overflow': ((80.0, 80.0, 4.0), 3000)}


@pytest.mark.parametrize('m_cap', [None, 512], ids=['all cells', 'm=512'])
@pytest.mark.parametrize('extent', list(EXTENTS))
def test_cell_cluster_pair_keys_matches(extent, m_cap):
    """``pair_keys=True``: the port's int64 keys give the reference's pair
    path array for array, on a room and where 13 groups x d0*d1*d2 pass
    2^31 (one int32 key would overflow); m_cap=512 truncates cells."""
    ext, n = EXTENTS[extent]
    pts, group, valid, payload = _entries(np.asarray(ext), n, seed=5)
    cells = _grid_cells(pts, valid)
    if extent == 'int32 overflow':
        assert N_GROUPS * cells > 2 ** 31
    else:
        assert N_GROUPS * cells < 2 ** 31
    thr = np.full(N_GROUPS, 3.0, np.float32)
    jl, jp = _jax_csr(m_cap)(jnp.asarray(pts), jnp.asarray(group),
                             jnp.asarray(valid), jnp.asarray(payload),
                             jnp.asarray(thr))
    tl, tp = grp.cell_cluster_csr(_t(pts), _t(group), _t(valid),
                                  _t(payload), _t(thr), RADIUS,
                                  cell_scale=1.0, m_cap=m_cap,
                                  pair_keys=True)
    assert tl.dtype == tp.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert len(np.unique(tl.numpy()[tl.numpy() >= 0])) > 10


@pytest.mark.parametrize('m_cap', [None, 512], ids=['all cells', 'm=512'])
def test_pair_keys_equal_single_key(m_cap):
    """Where one int32 key fits, int64 keys (pair_keys=True) and int32
    keys (False) give the same labels and payload."""
    pts, group, valid, payload = _entries(np.array([6.0, 6.0, 3.0]), 4096,
                                          seed=6)
    thr = np.full(N_GROUPS, 3.0, np.float32)
    out = [grp.cell_cluster_csr(_t(pts), _t(group), _t(valid), _t(payload),
                                _t(thr), RADIUS, cell_scale=1.0,
                                m_cap=m_cap, pair_keys=pk)
           for pk in (True, False)]
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert int((out[0][0] >= 0).sum()) > 200


def test_cell_core_int64_keys():
    """The pair path's cells carry int64 keys and decode each cell's group
    from its key: every sorted entry's group equals its cell's."""
    pts, group, valid, _ = _entries(np.array([80.0, 80.0, 4.0]), 3000,
                                    seed=7)
    m = 4096
    assert grp.key_dtype(True) == torch.int64
    assert grp.key_dtype(False) == torch.int32
    core = grp._cell_core(_t(pts), _t(group), _t(valid),
                          torch.arange(3000, dtype=torch.int32), RADIUS, 1.0,
                          96, m, grp.key_dtype(True))
    assert core['cell_group'].dtype == torch.int64
    cid = core['cid_s'].long()
    ok = cid < m
    assert int(ok.sum()) == int(valid.sum())
    ent_group = _t(group)[core['payload_s'].long()]
    assert torch.equal(core['cell_group'][cid[ok]], ent_group[ok].long())
    assert int(core['cell_valid'].sum()) > 1000


def _int64_table(keys32):
    k = keys32.to(torch.int64)
    return torch.where(keys32 == 2 ** 31 - 1, torch.iinfo(torch.int64).max,
                       k)


@pytest.mark.parametrize('reach', [1, 2])
def test_k3_plain_int64_equals_int32(reach):
    """K3's plain version on int64 keys (int64 sentinel) equals the int32
    run on the same cells."""
    pts, group, valid, payload = _entries(np.array([6.0, 6.0, 3.0]), 4096,
                                          seed=8)
    # the cells' table: sorted unique keys, padded
    s = np.float32(RADIUS)
    mn = pts[valid].min(0)
    cell = np.floor((pts - mn) / s).astype(np.int64)
    dims = (cell[valid].max(0) + 2).astype(np.int64)
    key = ((group.astype(np.int64) * dims[0] + cell[:, 0]) * dims[1]
           + cell[:, 1]) * dims[2] + cell[:, 2]
    uk, first = np.unique(key[valid], return_index=True)
    m = len(uk) + 77
    keys32 = np.full(m, 2 ** 31 - 1, np.int64)
    keys32[:len(uk)] = uk
    cc = np.zeros((m, 3), np.int32)
    cc[:len(uk)] = cell[valid][first]
    cen = np.zeros((m, 3), np.float32)
    cen[:len(uk)] = pts[valid][first]
    k32 = _t(keys32.astype(np.int32))
    args = (_t(cen), _t(cc), _t(dims.astype(np.int32)), grp.offsets(reach),
            RADIUS * reach)
    got = cell_neighbor_join_plain(_int64_table(k32), *args)
    want = cell_neighbor_join_plain(k32, *args)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want) and int((want >= 0).sum()) > 100


PAIR = dict(TINY, grouping_cfg={k: v for k, v in TINY['grouping_cfg'].items()
                                if k != 'pair_keys'})


@pytest.fixture(scope='module')
def tiny_batches():
    data = tiny_data()
    tb = build_scene_batch(*batch_args(data), Capacities(**CAPS),
                           num_levels=3, device='cpu')
    jb = jax_batch(*batch_args(data), JCaps(**CAPS), num_levels=3)
    return tb, jb


def _proposal_sets(entry_pt, entry_seg, entry_valid):
    props = {}
    for s, pt in zip(entry_seg[entry_valid], entry_pt[entry_valid]):
        props.setdefault(int(s), set()).add(int(pt))
    return sorted(tuple(sorted(v)) for v in props.values())


def test_forward_grouping_pair_keys_matches(tiny_batches):
    """forward_grouping at the default pair_keys (True) against the
    reference's: the same proposals, entry for entry, and the same point
    sets as the int32 path."""
    tb, jb = tiny_batches
    cfg = tiny_cfg(PAIR)
    assert 'pair_keys' not in cfg.grouping_cfg
    rng = np.random.RandomState(12)
    p = tb.coords_float.shape[0]
    sem = logits_clear_of(rng, p, 6, 0.1)
    off = (rng.randint(-3, 4, (p, 3)) / 64).astype(np.float32)
    ref = jax_forward_grouping(
        jnp.asarray(sem), jnp.asarray(off), jb.batch_idxs, jb.coords_float,
        jb.pyramid.point_valid, cfg, JCaps(**CAPS))
    out = forward_grouping(_t(sem), _t(off), tb.batch_idxs, tb.coords_float,
                           tb.pyramid.point_valid, cfg, Capacities(**CAPS))
    assert int(ref.n_proposals) >= 3
    for f in ('entry_pt', 'entry_seg', 'entry_valid', 'n_proposals',
              'prop_valid'):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    single = forward_grouping(_t(sem), _t(off), tb.batch_idxs,
                              tb.coords_float, tb.pyramid.point_valid,
                              tiny_cfg(TINY), Capacities(**CAPS))
    assert _proposal_sets(out.entry_pt.numpy(), out.entry_seg.numpy(),
                          out.entry_valid.numpy()) == _proposal_sets(
        single.entry_pt.numpy(), single.entry_seg.numpy(),
        single.entry_valid.numpy())


# ---------------------------------------------------------------------------
# datasets, transforms and the loader
# ---------------------------------------------------------------------------

VOXEL_CFG = dict(scale=50, spatial_shape=[128, 512], max_npoint=2500,
                 min_npoint=500)


def _write_rooms(root, prefix, n_rooms=2, n_points=10000, seed=0,
                 on_grid=False, label_dtype=np.float64, blobs=False):
    """S3DIS-like rooms as ``<prefix>_room<i>_inst_nostuff.pth`` under
    ``root``: 13-class ``make_room_scene`` rooms, labels float64 as the
    prepared format stores them (or ``label_dtype``).  ``on_grid``: xyz (float64) placed so that
    the test transform's fixed rotation lands every point on the 1/64
    grid (exact grouping centroids on both sides).  ``blobs``: furniture
    as ``make_scene``'s separate blobs, not room shells."""
    rng = np.random.RandomState(seed)
    theta = 0.35 * np.pi
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    for i in range(n_rooms):
        kw = dict(n_points=n_points, n_instances=8, semantic_classes=13,
                  thing_start=2)
        xyz, rgb, sem, inst = (make_scene(rng, room=3.0, **kw) if blobs
                               else make_room_scene(rng, **kw))
        if on_grid:
            # (kept 1 m off zero: a tiny residue of the rotation at 0 is a
            # float32 of its own)
            xyz = (np.round(xyz.astype(np.float64) * 64) / 64 + 1.0) @ rot.T
        torch.save((xyz, rgb, sem.astype(label_dtype),
                    inst.astype(label_dtype)),
                   str(root / f'{prefix}_room{i}_inst_nostuff.pth'))
    return str(root)


@pytest.fixture(scope='module')
def rooms(tmp_path_factory):
    return _write_rooms(tmp_path_factory.mktemp('s3dis'), 'Area_5')


@pytest.fixture(scope='module')
def int_rooms(tmp_path_factory):
    return _write_rooms(tmp_path_factory.mktemp('s3dis_int'), 'Area_5',
                        label_dtype=np.int64)


def test_s3dis_train_x4_reads_float_labels(rooms):
    """The train-x4 subsample of prepared files (float64 labels) relabels
    integer instance ids: the port casts them first (the reference indexes
    with the float labels and raises)."""
    kw = dict(data_root=rooms, prefix='Area_5', suffix='_inst_nostuff.pth',
              voxel_cfg=Config(VOXEL_CFG), training=True, seed=3,
              x4_split=True)
    with pytest.raises(IndexError):
        JS3DISDataset(**kw)[0]
    item = S3DISDataset(**kw)[0]
    assert item['instance_label'].dtype == np.int32
    assert item['inst_num'] == item['instance_label'].max() + 1 > 0


def _assert_same(a, b, what=''):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), what
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _assert_same(a[k], b[k], f'{what}.{k}')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize('training,x4_split', [(False, True), (False, False),
                                               (True, True)],
                         ids=['test x4', 'test', 'train x4'])
def test_s3dis_dataset_matches(rooms, int_rooms, training, x4_split):
    """S3DISDataset against the reference's on the same files and seed:
    every item and the collated batch, array for array (x4_split test:
    part i % 4 as the voxel batch coordinate, per-part min subtraction,
    grouping_batch_idxs 0; train: the 1/4 subsample, augmentation, crop)."""
    # the reference's train-x4 subsample relabels the file's instance
    # labels before they are cast to int: it needs integer labels there
    kw = dict(data_root=int_rooms if training else rooms, prefix='Area_5',
              suffix='_inst_nostuff.pth', voxel_cfg=Config(VOXEL_CFG),
              training=training, seed=3, x4_split=x4_split)
    mine, ref = S3DISDataset(**kw), JS3DISDataset(**kw)
    assert [f.split('/')[-1] for f in mine.filenames] == [
        f.split('/')[-1] for f in ref.filenames]
    items = [(mine[i], ref[i]) for i in range(len(mine))]
    for a, b in items:
        assert a is not None and b is not None
        _assert_same(a, b, 'item')
    n = 1 if not training else 2
    batch = mine.collate_fn([a for a, _ in items[:n]])
    _assert_same(batch, ref.collate_fn([b for _, b in items[:n]]), 'batch')
    if x4_split and not training:
        assert batch['x4_split'] is True
        n_pts = len(batch['coords'])
        assert (batch['coords'][:, 0] == np.arange(n_pts) % 4).all()
        assert (batch['grouping_batch_idxs'] == 0).all()
        for k in range(4):
            assert (batch['coords'][k::4, 1:].min(0) == 0).all()


@pytest.mark.parametrize('training', [True, False], ids=['train', 'test'])
def test_custom_dataset_matches(tmp_path, training):
    """CustomDataset in both modes against the reference's: the same
    augmentation draws, crop and relabelling, every array equal."""
    root = tmp_path / 'scans'
    root.mkdir()
    _write_rooms(root, 'scene', n_rooms=2, n_points=6000, seed=1)
    kw = dict(data_root=str(tmp_path), prefix='scans',
              suffix='_inst_nostuff.pth', voxel_cfg=Config(VOXEL_CFG),
              training=training, seed=4)
    mine, ref = CustomDataset(**kw), JCustomDataset(**kw)
    assert len(mine) == len(ref) == 2
    items = [(mine[i], ref[i]) for i in range(2)]
    for a, b in items:
        _assert_same(a, b, 'item')
    if training:
        assert len(items[0][0]['coord']) <= VOXEL_CFG['max_npoint']
    _assert_same(mine.collate_fn([a for a, _ in items]),
                 ref.collate_fn([b for _, b in items]), 'batch')


def test_transforms_match():
    """Each transform against the reference's, from the same seed."""
    rng = np.random.RandomState(0)
    xyz = (rng.rand(3000, 3) * [4.0, 4.0, 2.5]).astype(np.float32)
    for kw in (dict(), dict(jitter=True, flip=True, rot=True, scale=True)):
        a = transforms.augment_xyz(xyz, np.random.RandomState(1), **kw)
        b = jtransforms.augment_xyz(xyz, np.random.RandomState(1), **kw)
        np.testing.assert_array_equal(a, b)
    a = transforms.elastic_distort(xyz * 50, 6, 40.0,
                                   np.random.RandomState(2))
    b = jtransforms.elastic_distort(xyz * 50, 6, 40.0,
                                    np.random.RandomState(2))
    np.testing.assert_array_equal(a, b)
    a = transforms.crop_to_size(xyz * 50, 1000, 128,
                                np.random.RandomState(3))
    b = jtransforms.crop_to_size(xyz * 50, 1000, 128,
                                 np.random.RandomState(3))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[1].sum() <= 1000
    inst = rng.randint(-1, 9, 3000).astype(np.int64) * 3
    keep = rng.rand(3000) < 0.5
    np.testing.assert_array_equal(transforms.relabel_instances(inst, keep),
                                  jtransforms.relabel_instances(inst, keep))


@pytest.mark.parametrize('kind', ['s3dis', 'scannetv2', 'stpls3d'])
def test_build_dataset_and_loader_match(rooms, kind):
    """The registry builds each pair-key indoor dataset from a config
    section, and the test loader gives the reference loader's batches in
    its order."""
    cfg = dict(type=kind, data_root=rooms, prefix='Area_5',
               suffix='_inst_nostuff.pth', training=False,
               voxel_cfg=dict(VOXEL_CFG))
    if kind == 's3dis':
        cfg['x4_split'] = True
    else:   # the scans live under data_root/prefix for these
        cfg.update(data_root=str(rooms).rsplit('/', 1)[0],
                   prefix=str(rooms).rsplit('/', 1)[1])
    mine = build_dataset(Config(cfg))
    ref = jax_build_dataset(Config(cfg))
    assert type(mine).__name__ == type(ref).__name__
    assert mine.CLASSES == ref.CLASSES
    got = list(build_dataloader(mine, training=False))
    want = list(jax_build_dataloader(ref, training=False))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _assert_same(a, b, kind)


def test_build_dataset_kitti_and_training_loader_raise(rooms):
    """``type: kitti`` is registered: it reads the dataset's
    ``semantic-kitti.yaml``, which an S3DIS folder lacks.  The training
    loader works: the reference loader's shuffled batches of the S3DIS
    train split, array for array (same seed, ``num_workers=0``)."""
    with pytest.raises(FileNotFoundError, match='semantic-kitti.yaml'):
        build_dataset(dict(type='kitti', data_root=rooms, prefix='val',
                           suffix='.bin'))
    cfg = dict(type='s3dis', data_root=rooms, prefix='Area_5',
               suffix='_inst_nostuff.pth', training=True, seed=3,
               voxel_cfg=Config(VOXEL_CFG))
    mine = build_dataloader(build_dataset(cfg), batch_size=2, training=True)
    ref = jax_build_dataloader(jax_build_dataset(cfg), batch_size=2,
                               training=True)
    mine.set_epoch(1)
    ref.set_epoch(1)
    got, want = list(mine), list(ref)
    assert len(got) == len(want) == len(mine) == 1
    _assert_same(got[0], want[0], 's3dis train')


# ---------------------------------------------------------------------------
# evaluators
# ---------------------------------------------------------------------------

def _eval_scans(seed, n_scans=3, n=4000, n_cls=13):
    """Per scan: the encoded gt (sem * 1000 + inst, 0 ignored; some
    instances below a 100-point gate) and predictions (rle masks that
    overlap gts, split them, or cover void)."""
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for s in range(n_scans):
        gt = np.zeros(n, np.int64)
        sizes = rng.randint(30, 600, 12)
        start = 0
        for i, size in enumerate(sizes):
            cls = rng.randint(1, n_cls + 1)
            gt[start:start + size] = cls * 1000 + i + 1
            start += size
        gt = gt[rng.permutation(n)]
        pr = []
        for i in range(20):
            ids = np.unique(gt[gt >= 1000])
            gid = ids[rng.randint(len(ids))]
            mask = (gt == gid) & (rng.rand(n) < rng.uniform(0.3, 1.0))
            mask |= rng.rand(n) < rng.uniform(0.0, 0.05)
            label = int(gid // 1000) if rng.rand() < 0.8 else \
                int(rng.randint(1, n_cls + 1))
            pr.append(dict(scan_id=f's{s}', label_id=label,
                           conf=float(rng.rand()),
                           pred_mask=rle_encode(mask.astype(np.uint8))))
        preds.append(pr)
        gts.append(gt)
    return preds, gts


@pytest.mark.parametrize('min_npoint', [None, 150])
def test_scannet_eval_matches(min_npoint):
    """ScanNetEval against the reference's on the same predictions and gt
    (ignored ids, a min_npoint gate), with one worker and a pool: equal."""
    preds, gts = _eval_scans(0)
    names = [f'c{i}' for i in range(13)]
    got = ScanNetEval(names, min_npoint=min_npoint).evaluate(preds, gts,
                                                             nproc=1)
    want = JScanNetEval(names, min_npoint=min_npoint).evaluate(preds, gts,
                                                               nproc=1)
    pooled = ScanNetEval(names, min_npoint=min_npoint).evaluate(preds, gts,
                                                                nproc=2)
    for k in ('all_ap', 'all_ap_50%', 'all_ap_25%', 'all_rc', 'all_rc_50%',
              'all_rc_25%'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(pooled[k], want[k], err_msg=k)
    assert got['classes'].keys() == want['classes'].keys()
    for name in names:
        for k, v in want['classes'][name].items():
            np.testing.assert_array_equal(got['classes'][name][k], v)
    assert 0 < got['all_ap_25%'] <= 1


def test_point_wise_metrics_match():
    rng = np.random.RandomState(1)
    gt = rng.randint(0, 13, 20000)
    gt[rng.rand(20000) < 0.1] = -100
    pred = np.where(rng.rand(20000) < 0.6, gt.clip(0), rng.randint(0, 13,
                                                                   20000))
    inst = np.where(rng.rand(20000) < 0.2, -100, rng.randint(0, 50, 20000))
    off_p = rng.randn(20000, 3).astype(np.float32)
    off_g = rng.randn(20000, 3).astype(np.float32)
    assert evaluate_semantic_miou(pred, gt) == jax_semantic_miou(pred, gt)
    assert evaluate_semantic_acc(pred, gt) == jax_semantic_acc(pred, gt)
    assert evaluate_offset_mae(off_p, off_g, inst) == jax_offset_mae(
        off_p, off_g, inst)


# ---------------------------------------------------------------------------
# entry points and run_eval end to end
# ---------------------------------------------------------------------------

def test_s3dis_cfg_and_caps():
    """``entry.s3dis_cfg`` is the whole yaml as the reference reads it;
    ``caps_from_cfg`` reads its capacity section as ``tools/train.py``
    does; the runner takes its model section and 7 levels."""
    cfg = entry.s3dis_cfg()
    assert cfg.to_dict() == jax_load_config(entry.S3DIS_YAML).to_dict()
    m = cfg.model
    assert (m.channels, m.num_blocks, m.semantic_classes,
            m.instance_classes) == (32, 7, 13, 13)
    assert list(m.sem2ins_classes) == [0, 1]
    assert 'pair_keys' not in m.grouping_cfg and m.test_cfg.x4_split
    assert cfg.data.test.x4_split and cfg.data.test.prefix == 'Area_5'
    caps = entry.caps_from_cfg(cfg)
    c = cfg.tpu.caps
    assert caps == Capacities(
        points=c.points, voxels=tuple(c.voxels),
        grouping_points=c.grouping_points, proposals=c.proposals,
        proposal_entries=c.proposal_entries, instances=c.instances,
        inst_voxels=tuple(c.inst_voxels), grouping_cells=c.grouping_cells)
    net = entry.build_net(Config(dict(m, channels=8, num_blocks=3)),
                          device='cpu')
    assert net.input_conv.kernel.shape[1] == 6
    kitti = entry.build_net(Config(dict(m, channels=8, num_blocks=3,
                                        in_channels=1)), device='cpu')
    assert kitti.input_conv.kernel.shape[1] == 1
    runner = entry.build_s3dis_runner(net, cfg, device='cpu')
    assert runner.num_levels == 7 and runner.base_caps == caps
    assert runner.cfg is cfg.model and runner.device == torch.device('cpu')


def _mini_cfg(root):
    """A narrow S3DIS config (channels 8, 3 levels, 13 / 13 classes,
    sem2ins [0, 1], default pair_keys, x4_split) over a 2-scan split."""
    return Config(dict(
        model=dict(
            channels=8, num_blocks=3, semantic_classes=13,
            instance_classes=13, sem2ins_classes=[0, 1],
            semantic_only=False, ignore_label=-100, with_coords=True,
            grouping_cfg=dict(score_thr=0.05, radius=0.1, mean_active=300,
                              class_numpoint_mean=[-1.0] * 13,
                              npoint_thr=10, ignore_classes=[0, 1]),
            instance_voxel_cfg=dict(scale=10, spatial_shape=10),
            train_cfg=dict(max_proposal_num=32, pos_iou_thr=0.5),
            test_cfg=dict(x4_split=True, cls_score_thr=0.001,
                          mask_score_thr=-0.5, min_npoint=10,
                          eval_tasks=['semantic', 'instance'])),
        data=dict(test=dict(
            type='s3dis', data_root=root, prefix='Area_5',
            suffix='_inst_nostuff.pth', training=False, with_label=True,
            voxel_cfg=dict(scale=50, spatial_shape=[128, 512],
                           max_npoint=250000, min_npoint=5000),
            x4_split=True)),
        dataloader=dict(test=dict(batch_size=1, num_workers=0))))


def test_run_eval_matches(tmp_path):
    """run_eval end to end on a 2-scan S3DIS split with x4_split: the
    reference's weights in a narrow net; AP / AP_50 / AP_25 equal, mIoU,
    Acc and Offset_MAE within 1e-4."""
    root = _write_rooms(tmp_path, 'Area_5', n_rooms=2, n_points=6000,
                        seed=9, on_grid=True, blobs=True)
    cfg = _mini_cfg(root)
    ds = build_dataset(cfg.data.test)
    first = next(iter(build_dataloader(ds, training=False)))
    assert (np.round(first['coords_float'] * 64) / 64
            == first['coords_float']).all()
    caps = dict(CAPS, proposals=32, instances=32)
    # the reference's variables, initialised on the first scan
    init_caps = JCaps(**dict(caps, points=8192, voxels=(8192, 8192, 8192),
                             grouping_points=16384))
    jb = jax_batch(*batch_args(first), init_caps, num_levels=3,
                   batch_idxs=first['grouping_batch_idxs'])
    jnet, variables = jax_tiny_model(jb, cfg.model, init_caps)
    net = SoftGroupNet(channels=8, num_blocks=3, semantic_classes=13,
                       instance_classes=13, bf16=False)
    net.load_state_dict(from_jax_variables(variables))
    net.eval()
    want = jax_run_eval(jnet, variables, cfg, JCaps(**caps), 3)
    stats = []
    got = run_eval(net, cfg, Capacities(**caps), 3, device='cpu',
                   scene_stats=stats)
    assert sorted(got) == sorted(want) == sorted(
        ['AP', 'AP_50', 'AP_25', 'mIoU', 'Acc', 'Offset_MAE'])
    for k in ('AP', 'AP_50', 'AP_25'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ('mIoU', 'Acc', 'Offset_MAE'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert len(stats) == 2 and all(s['n_proposals'] > 0 for s in stats)
    assert got['AP_25'] > 0


def test_time_kernels_finds_s3dis_cases(tmp_path):
    """The S3DIS request's K1, K2 and K4 cases that ``chip_smoke.py`` holds
    to their plain versions are found in a recorded x4_split request of
    the S3DIS net (full width, bf16, the plain versions on the CPU) at its
    bucketed caps, and its K3 call joins int64 keys."""
    from softgroup_tpu_torch.model import blocks
    from softgroup_tpu_torch.model import softgroup as sg
    from softgroup_tpu_torch.ops import gather_kernel, sparse_conv
    from softgroup_tpu_torch.time_kernels import Recorder, request_args
    root = _write_rooms(tmp_path, 'Area_5', n_rooms=1, n_points=8000,
                        seed=3)
    cfg = entry.s3dis_cfg()
    cfg.data.test.data_root = root
    cfg.model.grouping_cfg.npoint_thr = 0.001   # a room of 8000 points
    net = entry.build_net(cfg.model, seed=1, device='cpu', bf16=True)
    with torch.no_grad():   # lift two classes over score_thr, as chip_smoke
        net.semantic_linear.final_bias[2:4] = 2.5
    runner = entry.build_s3dis_runner(net, cfg, device='cpu')
    data = next(iter(build_dataloader(build_dataset(cfg.data.test),
                                      training=False)))
    sites = [(sparse_conv, 'rulebook_conv'), (gather_kernel, 'row_gather'),
             (grp, 'row_gather'), (sg, 'row_gather'), (blocks, 'keyed_conv'),
             (grp, 'cell_neighbor_join')]
    stats = {}
    with Recorder(sites) as rec:
        runner.run_scene(data, stats=stats)
    assert stats['n_proposals'] > 0
    caps = stats['caps']
    (keys, *_), _ = rec.calls['cell_neighbor_join'][0]
    assert keys.dtype == torch.int64 and keys.shape == (caps.grouping_cells,)
    cases = request_args(rec.calls, caps, 's3dis')
    assert [k.split(' ')[0] for k in cases] == ['K1'] * 2 + ['K2'] * 3 \
        + ['K4'] * 2
    v0, p = caps.voxels[0], caps.grouping_points
    (src, idx), _ = cases[f'K2 s3dis devoxelize (V0, 32) bf16 (V0={v0})']
    assert src.shape == (v0, 32) and idx.shape == (caps.points,)
    (src, idx), _ = cases[f'K2 s3dis grouping entries (N, 4) f32 -> P={p}']
    assert src.shape == (caps.points, 4) and idx.shape == (p,)
    (feats, w, rules), _ = cases[f'K1 s3dis L0 subm 32->32 bf16 (V0={v0})']
    assert feats.shape == (v0, 32) and rules.shape == (27, v0)
