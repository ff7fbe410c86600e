"""Parity of the port's SemanticKITTI panoptic slice with the JAX reference
on the CPU: the KITTI dataset, ``panoptic_fusion``, ``PanopticEval``, the
runner's and ``summarize``'s panoptic branches through ``run_eval``, the
reference-weight import, the result writers and the test CLI.

Scans are written to tmp dirs as ``sequences/08/velodyne/*.bin`` and
``labels/*.label`` beside a copy of ``dataset/kitti/semantic-kitti.yaml``.
The end-to-end scans are stored rotated by -0.35 pi, so that the test
transform's fixed rotation puts the coordinates the model sees on a 1/64
grid and every f32 centroid sum is exact on both sides.  Tolerances:
dataset arrays, panoptic codes, written files and PQ exact; the evaluator's
keys within 1e-12.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml

from softgroup_tpu.data import build_dataloader as jax_build_dataloader
from softgroup_tpu.data import build_dataset as jax_build_dataset
from softgroup_tpu.data.kitti import KITTIDataset as JKITTIDataset
from softgroup_tpu.data.padding import build_scene_batch as jax_batch
from softgroup_tpu.evaluation.panoptic_eval import \
    PanopticEval as JPanopticEval
from softgroup_tpu.evaluation.postprocess import \
    panoptic_fusion as jax_panoptic_fusion
from softgroup_tpu.model.softgroup import Capacities as JCaps
from softgroup_tpu.tools_impl.test_runner import InferenceRunner as JaxRunner
from softgroup_tpu.tools_impl.test_runner import run_eval as jax_run_eval
from softgroup_tpu.tools_impl.test_runner import summarize as jax_summarize
from softgroup_tpu.util.checkpoint import \
    import_reference_weights as jax_import_reference_weights
from softgroup_tpu.util.config import load_config as jax_load_config
from softgroup_tpu_torch import entry
from softgroup_tpu_torch.data import (DATASETS, KITTIDataset,
                                      build_dataloader, build_dataset)
from softgroup_tpu_torch.evaluation.panoptic_eval import PanopticEval
from softgroup_tpu_torch.evaluation.postprocess import panoptic_fusion
from softgroup_tpu_torch.model.softgroup import Capacities, SoftGroupNet
from softgroup_tpu_torch.tools_impl import test_cli
from softgroup_tpu_torch.tools_impl.test_runner import run_eval, run_split
from softgroup_tpu_torch.util import checkpoint
from softgroup_tpu_torch.util.config import Config, load_config
from softgroup_tpu_torch.util.convert import from_jax_variables
from softgroup_tpu_torch.util.rle import rle_encode

from test_parity import make_ref_state_dict
from torch_helpers import CAPS, batch_args, jax_tiny_model

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)   # tools/test.py, the reference's writers
META = os.path.join(ROOT, 'dataset', 'kitti', 'semantic-kitti.yaml')
THETA = 0.35 * np.pi
ROT = np.array([[np.cos(THETA), np.sin(THETA), 0],
                [-np.sin(THETA), np.cos(THETA), 0], [0, 0, 1]])
# raw ids of the yaml's learning_map: stuff, things, and unlabeled (0)
STUFF_RAW = (40, 48, 50, 70, 72)
THING_RAW = (10, 18, 30, 31)
VOXEL_CFG = dict(scale=20, spatial_shape=[128, 512], max_npoint=2500,
                 min_npoint=300)


def _scan(rng, n, on_grid):
    """(xyz f32 (n', 3), remission f32 (n', 1), raw label int32 (n',)):
    a ground of stuff strips, a façade, then blobs of things, each thing
    with a sparse raw instance id; ~3% unlabeled.  ``on_grid``: the points
    are drawn on a 1/64 grid in the frame the test transform rotates into,
    stored rotated back, and kept where the f32 round trip lands on the
    grid again."""
    n_stuff = int(n * 0.4)
    g = np.empty((n, 3))
    g[:n_stuff, :2] = rng.rand(n_stuff, 2) * 30 - 15
    g[:n_stuff, 2] = -1.7 + rng.rand(n_stuff) * 0.05
    wall = np.arange(n_stuff) % 5 == 0      # a façade at y = 12
    g[:n_stuff][wall, 1] = 12 + rng.rand(wall.sum()) * 0.1
    g[:n_stuff][wall, 2] = -1.7 + rng.rand(wall.sum()) * 6
    sem = np.asarray(STUFF_RAW)[np.clip(
        ((g[:n_stuff, 0] + 15) // 6).astype(int), 0, len(STUFF_RAW) - 1)]
    sem = np.where(wall, 50, sem)
    inst = np.zeros(n, np.int64)
    n_things = 6
    counts = rng.multinomial(n - n_stuff, np.ones(n_things) / n_things)
    start = n_stuff
    t_sem = []
    for i, c in enumerate(counts):
        centre = np.r_[rng.rand(2) * 24 - 12, -1.0]
        g[start:start + c] = centre + rng.randn(c, 3) * [0.25, 0.2, 0.2]
        t_sem.append(np.full(c, THING_RAW[i % len(THING_RAW)]))
        inst[start:start + c] = rng.randint(1, 30000)
        start += c
    sem = np.concatenate([sem] + t_sem)
    sem[rng.rand(n) < 0.03] = 0
    if on_grid:
        g = np.round(g * 64) / 64
    xyz = (g @ ROT.T).astype(np.float32)
    if on_grid:
        keep = ((xyz @ ROT).astype(np.float32) == g).all(1)
        xyz, sem, inst = xyz[keep], sem[keep], inst[keep]
    rem = rng.rand(len(xyz), 1).astype(np.float32)
    raw = (sem | (inst << 16)).astype(np.int32)
    return xyz, rem, raw


def _write_kitti(root, n_scans=2, n=3000, seed=0, on_grid=False, seq=8):
    """SemanticKITTI layout under ``root``: the metadata, then ``n_scans``
    scans of sequence ``seq``; returns ``root`` as str."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    shutil.copy(META, os.path.join(root, 'semantic-kitti.yaml'))
    base = os.path.join(root, 'sequences', f'{seq:02d}')
    os.makedirs(os.path.join(base, 'velodyne'), exist_ok=True)
    os.makedirs(os.path.join(base, 'labels'), exist_ok=True)
    for i in range(n_scans):
        xyz, rem, raw = _scan(rng, n, on_grid)
        np.concatenate([xyz, rem], 1).tofile(
            os.path.join(base, 'velodyne', f'{i:06d}.bin'))
        raw.tofile(os.path.join(base, 'labels', f'{i:06d}.label'))
    return str(root)


@pytest.fixture(scope='module')
def scans(tmp_path_factory):
    return _write_kitti(tmp_path_factory.mktemp('kitti'), seed=0)


def _assert_same(a, b, what=''):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _assert_same(a[k], b[k], f'{what}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f'{what}[{i}]')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------

def _datasets(root, training, prefix='val'):
    kw = dict(data_root=root, prefix=prefix, suffix='.bin',
              voxel_cfg=Config(VOXEL_CFG), training=training, seed=5)
    return KITTIDataset(**kw), JKITTIDataset(**kw)


def test_kitti_load_and_maps_match(scans):
    """``load`` (the learning_map remap: stuff 0..10, things 11..18, 0 ->
    -100; stuff carries no instance), the label maps and the file list."""
    ds, js = _datasets(scans, training=False)
    assert ds.filenames == js.filenames and len(ds) == 2
    np.testing.assert_array_equal(ds.learning_map, js.learning_map)
    assert ds.learning_map_inv == js.learning_map_inv
    for fn in ds.filenames:
        got, want = ds.load(fn), js.load(fn)
        _assert_same(list(got), list(want), 'load')
        xyz, rem, sem, inst = got
        assert rem.shape == (len(xyz), 1)
        assert set(np.unique(sem)) <= set([-100] + list(range(19)))
        assert (sem > 10).any() and (inst[sem <= 10] == -100).all()
        assert (inst[sem > 10] != -100).all()
    assert ds.label_shift(np.array([11, 18, -100])).tolist() == [0, 7, -100]


@pytest.mark.parametrize('training', [False, True], ids=['test', 'train'])
def test_kitti_items_and_collate_match(scans, training):
    """``__getitem__`` under one seed (``transform_test``'s fixed
    rotation; ``transform_train``'s augment, 1/5-scale elastic distortion
    and crop), the sequence-scoped scan ids and ``collate_fn``: every array
    equal."""
    ds, js = _datasets(scans, training)
    items, jitems = [ds[i] for i in range(2)], [js[i] for i in range(2)]
    for a, b in zip(items, jitems):
        _assert_same(a, b, 'item')
    assert [it['scan_id'] for it in items] == [
        'sequences/08/velodyne/000000', 'sequences/08/velodyne/000001']
    if training:   # the crop took effect: fewer points than the scan
        assert len(items[0]['coord']) <= VOXEL_CFG['max_npoint']
    _assert_same(ds.collate_fn(items), js.collate_fn(jitems), 'batch')


def test_kitti_relabel_and_registry(scans):
    """Sparse raw instance ids compact to 0..K-1 in ascending order,
    keeping -100; ``build_dataset`` builds ``type: kitti``."""
    ids = np.array([70000, -100, 5, 70000, 131073, 5, -100])
    want = JKITTIDataset._relabel_sparse_ids(ids)
    np.testing.assert_array_equal(KITTIDataset._relabel_sparse_ids(ids),
                                  want)
    assert want.tolist() == [1, -100, 0, 1, 2, 0, -100]
    assert DATASETS['kitti'] is KITTIDataset
    ds = build_dataset(dict(type='kitti', data_root=scans, prefix='val',
                            suffix='.bin', training=False,
                            voxel_cfg=Config(VOXEL_CFG)))
    data = next(iter(build_dataloader(ds, training=False)))
    assert data['scan_ids'] == ['sequences/08/velodyne/000000']
    assert data['feats'].shape == (len(data['coords']), 1)


# ---------------------------------------------------------------------------
# panoptic fusion and the evaluator
# ---------------------------------------------------------------------------

FUSION_CFG = Config(dict(test_cfg=dict(panoptic_skip_iou=0.5)))


def _instances(rng, n, k, n_cls=8):
    """``k`` instances over ``n`` points: masks that overlap each other
    (so some are skipped), random labels and scores."""
    out = []
    for _ in range(k):
        mask = np.zeros(n, np.uint8)
        a = rng.randint(0, n - 1)
        mask[a:min(n, a + rng.randint(1, max(2, n // 4)))] = 1
        mask[rng.rand(n) < 0.01] = 1
        out.append(dict(scan_id='s', label_id=int(rng.randint(1, n_cls + 1)),
                        conf=float(rng.rand()), pred_mask=rle_encode(mask)))
    return out


@pytest.mark.parametrize('n,k', [(5000, 12), (5000, 0), (70000, 6)],
                         ids=['overlaps', 'empty', 'wide'])
def test_panoptic_fusion_matches(n, k):
    """Equal codes: instances pasted by descending score with overlap
    skips, unpasted things marked ignore (19), an empty instance list,
    and more than 65535 points."""
    rng = np.random.RandomState(n + k)
    sem = rng.randint(0, 19, n).astype(np.int64)
    insts = _instances(rng, n, k)
    got = panoptic_fusion(sem, insts, FUSION_CFG, 19, 8)
    want = jax_panoptic_fusion(sem, insts, FUSION_CFG, 19, 8)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    ids = got >> 16
    assert ((got & 0xFFFF) <= 19).all()
    if k:
        # some instance was pasted, some skipped
        assert 0 < len(np.unique(ids[ids > 0])) < k
    else:
        np.testing.assert_array_equal(
            got, np.where(sem >= 11, 19, sem).astype(np.uint32))


def _pq_inputs(seed, n_scans=3, n=6000):
    """Per scan: panoptic codes, gt semantics (some ignored) and gt
    instances (stuff -100), with segments below ``min_points``."""
    rng = np.random.RandomState(seed)
    preds, sems, insts = [], [], []
    for _ in range(n_scans):
        sem = rng.randint(0, 19, n).astype(np.int64)
        sem[rng.rand(n) < 0.05] = -100
        inst = np.where(sem >= 11, rng.randint(0, 12, n), -100)
        # a few tiny gt segments (under 50 points)
        tiny = rng.choice(n, 30, replace=False)
        inst[tiny] = np.where(sem[tiny] >= 11, 99, inst[tiny])
        p_sem = np.where(rng.rand(n) < 0.8, np.clip(sem, 0, 18),
                         rng.randint(0, 20, n)).astype(np.uint32)
        p_id = np.where(p_sem >= 11, (inst.clip(-1) + 1 + (rng.rand(n) < 0.1)
                                      * rng.randint(0, 3, n)), 0)
        preds.append((p_sem & 0xFFFF) | (p_id.astype(np.uint32) << 16))
        sems.append(sem)
        insts.append(inst)
    return preds, sems, insts


@pytest.mark.parametrize('nproc', [1, 2])
@pytest.mark.parametrize('min_points', [50, 1])
def test_panoptic_eval_matches(nproc, min_points):
    preds, sems, insts = _pq_inputs(3)
    ev = PanopticEval(KITTIDataset.THING, KITTIDataset.STUFF,
                      min_points=min_points)
    jev = JPanopticEval(JKITTIDataset.THING, JKITTIDataset.STUFF,
                        min_points=min_points)
    got = ev.evaluate(preds, sems, insts, nproc=nproc, verbose=False)
    want = jev.evaluate(preds, sems, insts, nproc=nproc, verbose=False)
    assert sorted(got) == sorted(want) == sorted(
        ['PQ', 'PQ_dagger', 'SQ', 'RQ', 'mIoU', 'PQ_th', 'PQ_st',
         'per_class'])
    for k in ('PQ', 'PQ_dagger', 'SQ', 'RQ', 'mIoU', 'PQ_th', 'PQ_st'):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    for k in want['per_class']:
        np.testing.assert_allclose(got['per_class'][k],
                                   want['per_class'][k], rtol=0, atol=1e-12,
                                   err_msg=k)
    assert 0 < got['PQ'] < 100 and 0 < got['mIoU'] < 100


# ---------------------------------------------------------------------------
# run_eval end to end, the weights import, the writers and the CLI
# ---------------------------------------------------------------------------

E2E_CAPS = dict(CAPS, proposals=32, instances=32)
# the thing class the random init is lifted on (score_thr 0.2)
LIFT = 11


def _mini_cfg(root, semantic_only=False):
    """``configs/softgroup/softgroup_kitti.yaml`` at a narrow width
    (channels 8, 3 levels; in_channels 1, with_coords False, 19 / 8
    classes, the panoptic task from the yaml), its test split at
    ``root``, in-process loading, the e2e caps."""
    cfg = entry.kitti_cfg()
    if semantic_only:
        cfg.model = load_config(entry.KITTI_YAML.replace(
            'softgroup_kitti.yaml', 'softgroup_kitti_backbone.yaml')).model
    cfg.model.channels, cfg.model.num_blocks = 8, 3
    cfg.data.test.data_root = root
    cfg.dataloader.test.num_workers = 0
    cfg.tpu = Config(dict(num_levels=3, bf16=False, caps=E2E_CAPS))
    return cfg


@pytest.fixture(scope='module')
def e2e(tmp_path_factory):
    """A 2-scan split on the 1/64 grid, the reference's tiny net and
    variables (thing classes lifted) and the port's net with the same
    weights."""
    root = _write_kitti(tmp_path_factory.mktemp('kitti_e2e'), n=4000,
                        seed=11, on_grid=True)
    cfg = _mini_cfg(root)
    first = next(iter(build_dataloader(build_dataset(cfg.data.test),
                                       training=False)))
    assert (np.round(first['coords_float'] * 64) / 64
            == first['coords_float']).all()
    init_caps = JCaps(**dict(E2E_CAPS, points=8192,
                             voxels=(8192, 8192, 8192),
                             grouping_points=16384))
    jb = jax_batch(*batch_args(first), init_caps, num_levels=3,
                   with_coords=False)
    jnet, variables = jax_tiny_model(jb, cfg.model, init_caps)
    variables['params']['semantic_linear']['final_bias'][LIFT] += 3.0
    net = SoftGroupNet(channels=8, num_blocks=3, semantic_classes=19,
                       instance_classes=8, in_channels=1, bf16=False)
    net.load_state_dict(from_jax_variables(variables))
    net.eval()
    return root, cfg, jnet, variables, net


def test_run_eval_panoptic_matches(e2e):
    """``run_eval`` on a 2-scan KITTI split with the reference's weights:
    the panoptic codes equal the reference runner's array for array, and
    PQ equals the reference's."""
    root, cfg, jnet, variables, net = e2e
    jds = jax_build_dataset(cfg.data.test)
    jrunner = JaxRunner(jnet, variables, cfg.model, JCaps(**E2E_CAPS), 3)
    refs = [jrunner.run_scene(data) for data in jax_build_dataloader(
        jds, batch_size=1, training=False)]
    want = jax_summarize(refs, cfg, jds)
    got = run_eval(net, cfg, Capacities(**E2E_CAPS), 3, device='cpu')
    assert sorted(got) == sorted(want) == ['PQ']
    assert got['PQ'] == want['PQ']
    stats = []
    results, dataset = run_split(net, cfg, Capacities(**E2E_CAPS), 3,
                                 device='cpu', scene_stats=stats)
    assert len(results) == len(refs) == 2
    for r, ref in zip(results, refs):
        assert r['scan_id'] == ref['scan_id']
        assert sorted(r) == sorted(ref) == [
            'instance_labels', 'panoptic_preds', 'scan_id',
            'semantic_labels']
        for k in ('panoptic_preds', 'semantic_labels', 'instance_labels'):
            assert r[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(r[k], ref[k], err_msg=k)
    assert all(s['n_instances'] > 0 and s['n_pasted'] > 0 for s in stats)
    assert dataset.learning_map_inv[1] == 10


def test_backbone_cfg_gives_empty_panoptic(e2e):
    """The semantic-only backbone yaml: no instances, so no panoptic
    codes and an empty metric dict, as the reference's."""
    root, _, jnet, variables, _ = e2e
    cfg = _mini_cfg(root, semantic_only=True)
    assert cfg.model.semantic_only and cfg.model.test_cfg.eval_tasks == [
        'panoptic']
    from softgroup_tpu.model.softgroup import SoftGroupNet as JNet
    jbb = JNet(channels=8, num_blocks=3, semantic_classes=19,
               instance_classes=8, semantic_only=True, bf16=False)
    net = SoftGroupNet(channels=8, num_blocks=3, semantic_classes=19,
                       instance_classes=8, semantic_only=True,
                       in_channels=1, bf16=False)
    state = from_jax_variables(variables)
    net.load_state_dict({k: state[k] for k in net.state_dict()})
    net.eval()
    want = jax_run_eval(jbb, variables, cfg, JCaps(**E2E_CAPS), 3,
                        max_scenes=1)
    results, _ = run_split(net, cfg, Capacities(**E2E_CAPS), 3,
                           max_scenes=1, device='cpu')
    got = run_eval(net, cfg, Capacities(**E2E_CAPS), 3, max_scenes=1,
                   device='cpu')
    assert got == want == {}
    assert sorted(results[0]) == ['instance_labels', 'scan_id',
                                  'semantic_labels']


def test_import_reference_weights_matches(e2e):
    """On a reference-layout state dict, the port's import equals the
    reference's import carried across, tensor for tensor, and loads n/n
    leaves of the full net; ``reference_state_dict`` gives the reference
    state dict back."""
    *_, variables, net = e2e
    sd = make_ref_state_dict(np.random.RandomState(3), 1, 8, 3, 19, 8)
    msgs = []

    class Rec:
        def info(self, m):
            msgs.append(m)

    got = checkpoint.import_reference_weights(net.state_dict(), sd, Rec())
    want = from_jax_variables(jax_import_reference_weights(variables, sd))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    n = len(net.state_dict())
    assert msgs == [f'import: loaded {n}/{n} tensors']
    back = checkpoint.reference_state_dict(got)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    # tolerant: a missing and a mismatched tensor keep their values
    sd.pop('input_conv.0.weight')
    sd['output_layer.0.weight'] = sd['output_layer.0.weight'][:3]
    msgs.clear()
    part = checkpoint.import_reference_weights(net.state_dict(), sd, Rec())
    assert torch.equal(part['input_conv.kernel'],
                       net.state_dict()['input_conv.kernel'])
    assert msgs[-1] == f'import: loaded {n - 2}/{n} tensors'
    assert any(m.startswith('import: missing input_conv.0.weight')
               for m in msgs)
    assert any(m.startswith('import: shape mismatch output_layer.0.weight')
               for m in msgs)


def _results(rng, kitti_ids, n_scans=2, n=3000):
    """Runner-like results of every task, on KITTI's sequence-scoped scan
    ids or on flat ones (the semantic and instance writers take a scan id
    as a file name)."""
    out = []
    for i in range(n_scans):
        sid = (f'sequences/08/velodyne/{i:06d}' if kitti_ids
               else f'scan{i:02d}')
        insts = _instances(rng, n, 5)
        for d in insts:
            d['scan_id'] = sid
        sem = rng.randint(0, 19, n).astype(np.int64)
        out.append(dict(
            scan_id=sid, semantic_preds=sem,
            semantic_labels=rng.randint(-1, 19, n).astype(np.int64),
            coords_float=rng.rand(n, 3).astype(np.float32),
            offset_preds=rng.randn(n, 3).astype(np.float32),
            offset_labels=rng.randn(n, 3).astype(np.float32),
            pred_instances=insts,
            gt_instances=rng.randint(0, 19000, n).astype(np.int64),
            panoptic_preds=panoptic_fusion(sem, insts, FUSION_CFG, 19, 8)))
    return out


def _tree(root):
    files = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, 'rb') as fh:
                files[os.path.relpath(p, root)] = fh.read()
    return files


def test_save_results_matches(scans, tmp_path):
    """The port's writers give byte-identical files to ``tools/test.py``'s
    on the same results: the panoptic ``.label``, the semantic ``.npy``
    and the instance ``.txt`` files."""
    from tools.test import save_results as jax_save_results
    rng = np.random.RandomState(4)
    ds, js = _datasets(scans, training=False)
    for tasks, kitti_ids in ((['semantic', 'instance'], False),
                             (['panoptic'], True)):
        results = _results(rng, kitti_ids)
        cfg = _mini_cfg(scans)
        cfg.model.test_cfg.eval_tasks = tasks
        test_cli.save_results(results, str(tmp_path / 'port'), cfg, ds)
        jax_save_results(results, str(tmp_path / 'ref'), cfg, js)
    got, want = _tree(tmp_path / 'port'), _tree(tmp_path / 'ref')
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    labels = sorted(k for k in got if k.endswith('.label'))
    assert labels == [
        f'panoptic/sequences/08/predictions/00000{i}.label' for i in (0, 1)]
    assert any(k.startswith('pred_instance/') for k in got)
    assert any(k.startswith('semantic_pred/') for k in got)
    # the .label decodes back to the learned classes through learning_map
    lab = np.fromfile(tmp_path / 'port' / labels[0], dtype=np.uint32)
    pan = results[0]['panoptic_preds']
    learned = ds.learning_map[lab & 0xFFFF]
    cls = pan & 0xFFFF
    np.testing.assert_array_equal(learned[cls < 19], cls[cls < 19])
    assert (learned[cls == 19] == -100).all()
    np.testing.assert_array_equal(lab >> 16, pan >> 16)


def test_cli_main_matches_run_eval(e2e, tmp_path):
    """The port's test CLI on the split (a reference-layout ``.pth`` of
    the port net's weights, ``--device cpu``) returns ``run_eval``'s
    metrics, imports n/n tensors and writes one ``.label`` a scan."""
    root, cfg, _, _, net = e2e
    want = run_eval(net, cfg, Capacities(**E2E_CAPS), 3, device='cpu')
    pth = str(tmp_path / 'ref.pth')
    torch.save({'net': checkpoint.reference_state_dict(net.state_dict())},
               pth)
    cfg_path = str(tmp_path / 'kitti.yaml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump(cfg.to_dict(), f)
    stats = []
    got = test_cli.main([cfg_path, '--checkpoint', pth, '--out',
                         str(tmp_path / 'out'), '--device', 'cpu'],
                        scene_stats=stats)
    assert got == want and np.isfinite(got['PQ'])
    assert len(stats) == 2
    labels = sorted(os.listdir(tmp_path / 'out' / 'panoptic' / 'sequences'
                               / '08' / 'predictions'))
    assert labels == ['000000.label', '000001.label']
    n0 = os.path.getsize(os.path.join(root, 'sequences', '08', 'labels',
                                      '000000.label'))
    assert os.path.getsize(tmp_path / 'out' / 'panoptic' / 'sequences'
                           / '08' / 'predictions' / '000000.label') == n0
    with pytest.raises(ValueError, match='reference .pth'):
        test_cli.main([cfg_path, '--checkpoint', str(tmp_path),
                       '--device', 'cpu'])


def test_kitti_cfg_and_caps():
    """``entry.kitti_cfg`` is the whole yaml, as the reference reads it;
    its net takes the remission alone (Cin 1)."""
    cfg = entry.kitti_cfg()
    assert cfg.to_dict() == jax_load_config(entry.KITTI_YAML).to_dict()
    m = cfg.model
    assert (m.channels, m.num_blocks, m.semantic_classes,
            m.instance_classes, m.in_channels) == (32, 7, 19, 8, 1)
    assert m.with_coords is False and 'pair_keys' not in m.grouping_cfg
    assert m.test_cfg.eval_tasks == ['panoptic'] and cfg.eval_min_npoint == 50
    caps = entry.caps_from_cfg(cfg)
    assert caps.grouping_cells == 131072 and caps.voxels[0] == 524288
    net = entry.build_net(Config(dict(m, channels=8, num_blocks=3)),
                          device='cpu', bf16=False)
    assert net.input_conv.kernel.shape == (27, 1, 8)


def test_time_kernels_finds_kitti_cases(tmp_path):
    """The KITTI request's K1, K2 and K4 cases that ``chip_smoke.py``
    holds to their plain versions are found in a recorded request of the
    KITTI net (full width, bf16, the plain versions on the CPU) at its
    bucketed caps: the input conv at Cin 1, and its K3 call joins int64
    keys."""
    from softgroup_tpu_torch.model import blocks
    from softgroup_tpu_torch.model import softgroup as sg
    from softgroup_tpu_torch.ops import gather_kernel, grouping, sparse_conv
    from softgroup_tpu_torch.time_kernels import Recorder, request_args
    root = _write_kitti(tmp_path, n_scans=1, n=6000, seed=3)
    cfg = entry.kitti_cfg()
    cfg.data.test.data_root = root
    cfg.dataloader.test.num_workers = 0
    net = entry.build_net(cfg.model, seed=0, device='cpu', bf16=True)
    with torch.no_grad():   # lift two thing classes, as chip_smoke
        net.semantic_linear.final_bias[11:13] = 2.5
    runner = entry.build_s3dis_runner(net, cfg, device='cpu')
    data = next(iter(build_dataloader(build_dataset(cfg.data.test),
                                      training=False)))
    sites = [(sparse_conv, 'rulebook_conv'), (gather_kernel, 'row_gather'),
             (grouping, 'row_gather'), (sg, 'row_gather'),
             (blocks, 'keyed_conv'), (grouping, 'cell_neighbor_join')]
    stats = {}
    with Recorder(sites) as rec:
        ret = runner.run_scene(data, stats=stats)
    assert stats['n_proposals'] > 0 and 'panoptic_preds' in ret
    caps = stats['caps']
    (keys, *_), _ = rec.calls['cell_neighbor_join'][0]
    assert keys.dtype == torch.int64 and keys.shape == (caps.grouping_cells,)
    cases = request_args(rec.calls, caps, 'kitti', None, 1)
    assert [k.split(' ')[0] for k in cases] == ['K1'] * 2 + ['K2'] * 3 \
        + ['K4'] * 2
    v0 = caps.voxels[0]
    (feats, w, rules), _ = cases[f'K1 kitti input conv 1->32 bf16 (V0={v0})']
    assert feats.shape == (v0, 1) and w.shape == (27, 1, 32)
    assert rules.shape == (27, v0)
    (src, idx), _ = cases[f'K2 kitti devoxelize (V0, 32) bf16 (V0={v0})']
    assert src.shape == (v0, 32) and idx.shape == (caps.points,)
