"""Parity of the port's offline evaluation tools with the reference's on
the CPU: ``evaluation/instance_eval_util.py`` (every case of
``tests/test_eval.py``'s ``TestInstanceEvalUtil``), ``tools_impl/
eval_saved.py``, ``eval_det.py`` (every case of ``tests/test_tools.py``'s
``TestEvalDet``) and ``visualization.py`` against ``tools/eval_saved.py``,
``tools/eval_det.py`` and ``tools/visualization.py``.  The saved result
directories are written once by the reference's ``tools/test.py`` writers
and once by the port's ``test_cli`` writers.  All of it is numpy: every
comparison is exact.
"""

import importlib.util
import os.path as osp
import struct
import sys

import numpy as np
import pytest
import yaml

from softgroup_tpu.evaluation import instance_eval_util as ref_util
from softgroup_tpu.evaluation.instance_eval import ScanNetEval
from softgroup_tpu.util.config import load_config as ref_load_config
from softgroup_tpu.util.rle import rle_encode
from softgroup_tpu_torch import evaluation as port_eval
from softgroup_tpu_torch.evaluation import instance_eval_util as port_util
from softgroup_tpu_torch.tools_impl import eval_det as port_det
from softgroup_tpu_torch.tools_impl import eval_saved as port_saved
from softgroup_tpu_torch.tools_impl import test_cli
from softgroup_tpu_torch.tools_impl import visualization as port_vis
from softgroup_tpu_torch.util.config import load_config

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _load_tool(name):
    """A module of ``tools/`` under the name ``ref_tool_<name>``."""
    mod_name = f'ref_tool_{name}'
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(
        mod_name, osp.join(REPO, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# instance_eval_util: TestInstanceEvalUtil's cases on both packages
# ---------------------------------------------------------------------------

def test_exports_match():
    """The port's ``evaluation`` exports the reference's names."""
    import softgroup_tpu.evaluation as ref_eval
    assert sorted(port_eval.__all__) == sorted(ref_eval.__all__)
    for name in port_eval.__all__:
        assert hasattr(port_eval, name), name


def test_transform_points():
    rng = np.random.RandomState(0)
    pts = rng.randn(50, 3).astype(np.float32)
    m = np.eye(4)
    m[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    m[:3, 3] = [1, 2, 3]
    m[3, 3] = 1.5
    got = port_util.transform_points(m, pts)
    np.testing.assert_array_equal(got, ref_util.transform_points(m, pts))
    np.testing.assert_allclose(
        port_util.transform_points(np.eye(4) + np.pad(
            np.array([[1.], [2.], [3.]]), ((0, 1), (3, 0))), pts[:2]),
        pts[:2] + [1, 2, 3], atol=1e-6)


def test_export_load_ids_roundtrip(tmp_path):
    ids = np.array([2001, 0, 3017, 2001], np.int64)
    for mod, name in ((port_util, 'port'), (ref_util, 'ref')):
        mod.export_ids(str(tmp_path / f'{name}.txt'), ids)
    assert (tmp_path / 'port.txt').read_bytes() == \
        (tmp_path / 'ref.txt').read_bytes()
    for mod in (port_util, ref_util):
        np.testing.assert_array_equal(
            mod.load_ids(str(tmp_path / 'port.txt')), ids)


@pytest.mark.parametrize('fmt', ['ascii', 'binary_little_endian'])
def test_read_mesh_vertices(tmp_path, fmt):
    """ASCII (the layout the visualization tool writes) and binary with
    mixed property types: the same vertices from both readers."""
    xyz = np.random.RandomState(1).randn(7, 3).astype(np.float32)
    path = tmp_path / 'm.ply'
    if fmt == 'ascii':
        port_vis.write_ply(str(path), xyz, np.full((7, 3), 10, np.float32))
    else:
        with open(path, 'wb') as f:
            f.write(b'ply\nformat binary_little_endian 1.0\n'
                    b'element vertex 7\n'
                    b'property float x\nproperty float y\n'
                    b'property float z\nproperty uchar red\nend_header\n')
            for p in xyz:
                f.write(struct.pack('<fffB', *p, 7))
    got = port_util.read_mesh_vertices(str(path))
    np.testing.assert_array_equal(got, ref_util.read_mesh_vertices(
        str(path)))
    np.testing.assert_allclose(got, xyz, atol=1e-4)


def test_instance_record_and_get_instances():
    ids = np.array([2001, 2001, 2001, 3001, 0, 0, 3002, 3002], np.int64)
    mine, ref = port_util.Instance(ids, 2001), ref_util.Instance(ids, 2001)
    assert mine.to_dict() == ref.to_dict()
    assert mine.to_json() == ref.to_json() and str(mine) == str(ref)
    assert mine.label_id == 2 and mine.vert_count == 3
    loaded = port_util.Instance(ids, -1)
    loaded.from_json(dict(instance_id=7, label_id=3, vert_count=4,
                          med_dist=0.5, dist_conf=0.25))
    assert loaded.to_dict() == dict(instance_id=7, label_id=3, vert_count=4,
                                    med_dist=0.5, dist_conf=0.25)
    args = (ids, [2, 3], ['chair', 'table'], {2: 'chair', 3: 'table'})
    got = port_util.get_instances(*args)
    assert got == ref_util.get_instances(*args)
    assert len(got['chair']) == 1 and len(got['table']) == 2


def test_export_and_read_prediction_files(tmp_path):
    """The benchmark's submission layout: the same files from both
    writers, the same records from both readers, and the reader's
    containment check."""
    label_ids = np.array([3, 3, 5, 5, 0, 7], np.int64)
    instance_ids = np.array([3001, 3001, 5002, 5002, 0, 7003], np.int64)
    for mod, name in ((port_util, 'port'), (ref_util, 'ref')):
        (tmp_path / name).mkdir()
        mod.export_instance_ids_for_eval(
            str(tmp_path / name / 'scene0000_00.txt'), label_ids,
            instance_ids)
    files = sorted(p.relative_to(tmp_path / 'ref')
                   for p in (tmp_path / 'ref').rglob('*') if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / 'port')
                           for p in (tmp_path / 'port').rglob('*')
                           if p.is_file())
    for rel in files:
        assert (tmp_path / 'port' / rel).read_bytes() == \
            (tmp_path / 'ref' / rel).read_bytes(), rel
    master = str(tmp_path / 'port' / 'scene0000_00.txt')
    info = port_util.read_instance_prediction_file(
        master, str(tmp_path / 'port'))
    assert info == ref_util.read_instance_prediction_file(
        master, str(tmp_path / 'port'))
    assert sorted(m['label_id'] for m in info.values()) == [3, 5, 7]
    assert all(port_util.load_ids(f).sum() == (2 if m['label_id'] < 7
                                               else 1)
               for f, m in info.items())
    with pytest.raises(ValueError, match='escapes'):
        port_util.read_instance_prediction_file(master,
                                                str(tmp_path / 'ref'))


# ---------------------------------------------------------------------------
# saved result directories, written by either package's writers
# ---------------------------------------------------------------------------

def _results(rng, n_scans=2, n=400, n_inst=3, n_cls=4):
    """``run_split``-style results of ``n_scans`` synthetic scans: gt
    instances, ~90% of each predicted (plus one spurious mask), semantic
    and offset predictions and coordinates."""
    out = []
    for s in range(n_scans):
        sid = f'scene{s:04d}_00'
        sem = rng.randint(1, n_cls + 1, n)
        inst = np.zeros(n, np.int64)
        preds = []
        for i in range(n_inst):
            sel = slice(i * (n // n_inst), (i + 1) * (n // n_inst))
            sem[sel] = (i % n_cls) + 1
            inst[sel] = i + 1
            idx = np.arange(n)[sel]
            mask = np.zeros(n, np.uint8)
            mask[idx[rng.rand(len(idx)) < 0.9]] = 1
            preds.append(dict(scan_id=sid, label_id=(i % n_cls) + 1,
                              conf=round(0.9 - 0.1 * i, 4),
                              pred_mask=rle_encode(mask)))
        spurious = (rng.rand(n) < 0.05).astype(np.uint8)
        preds.append(dict(scan_id=sid, label_id=n_cls, conf=0.05,
                          pred_mask=rle_encode(spurious)))
        gt = sem * 1000 + inst
        gt[inst == 0] = 0
        out.append(dict(
            scan_id=sid, pred_instances=preds, gt_instances=gt,
            semantic_preds=rng.randint(0, 20, n),
            semantic_labels=rng.randint(-100, 20, n),
            coords_float=rng.rand(n, 3).astype(np.float32) * 4,
            offset_preds=rng.randn(n, 3).astype(np.float32) * 0.1,
            offset_labels=rng.randn(n, 3).astype(np.float32) * 0.1))
    return out


def _config(tmp_path, dtype: str) -> str:
    path = tmp_path / f'{dtype}.yaml'
    with open(path, 'w') as f:
        yaml.safe_dump(dict(
            data=dict(test=dict(type=dtype, data_root='unused')),
            model=dict(test_cfg=dict(min_npoint=10,
                                     eval_tasks=['semantic', 'instance']))),
            f)
    return str(path)


@pytest.fixture(scope='module', params=['ref', 'port'])
def saved(request, tmp_path_factory):
    """{dataset type: (config path, result dir, results)} of two scans
    written by the reference's (``ref``) or the port's (``port``)
    ``save_results``: ScanNet (NYU ids in the files) and S3DIS (none)."""
    out = {}
    for dtype in ('scannetv2', 's3dis'):
        root = tmp_path_factory.mktemp(f'{request.param}_{dtype}')
        cfg_path = _config(root, dtype)
        results = _results(np.random.RandomState(0))
        if request.param == 'ref':
            _load_tool('test').save_results(results, str(root / 'out'),
                                            ref_load_config(cfg_path))
        else:
            test_cli.save_results(results, str(root / 'out'),
                                  load_config(cfg_path))
        out[dtype] = (cfg_path, str(root / 'out'), results)
    return out


@pytest.mark.parametrize('use_nyu', [False, True])
def test_eval_saved_matches(saved, use_nyu, monkeypatch):
    """The port's ``load_gt`` / ``load_pred`` read back the in-memory
    results, and its ``main`` gives the scores of the reference's
    ``main`` and of the in-memory ``ScanNetEval``, class by class."""
    from softgroup_tpu.data import DATASETS
    dtype = 'scannetv2' if use_nyu else 's3dis'
    cfg_path, out, results = saved[dtype]
    nyu_id = DATASETS[dtype].NYU_ID if use_nyu else None
    nyu_inv = ({int(v): i + 1 for i, v in enumerate(nyu_id)}
               if nyu_id else None)
    ref = _load_tool('eval_saved')
    for r in results:
        sid = r['scan_id']
        gt_path = osp.join(out, 'gt_instance', f'{sid}.txt')
        got = port_saved.load_gt(gt_path, nyu_inv)
        np.testing.assert_array_equal(got, r['gt_instances'])
        np.testing.assert_array_equal(got, ref.load_gt(gt_path, nyu_inv))
        preds = port_saved.load_pred(osp.join(out, 'pred_instance'), sid,
                                     nyu_inv)
        assert preds == ref.load_pred(osp.join(out, 'pred_instance'), sid,
                                      nyu_inv)
        assert [(p['label_id'], p['conf'], p['pred_mask']) for p in preds] \
            == [(p['label_id'], p['conf'], p['pred_mask'])
                for p in r['pred_instances']]

    mine = port_saved.main([cfg_path, out, '--nproc', '1'])
    captured = {}
    evaluate = ref.ScanNetEval.evaluate

    def keep(self, *a, **k):
        captured['res'] = evaluate(self, *a, **k)
        return captured['res']
    monkeypatch.setattr(ref.ScanNetEval, 'evaluate', keep)
    monkeypatch.setattr(sys, 'argv', ['eval_saved.py', cfg_path, out,
                                      '--nproc', '1'])
    ref.main()
    direct = ScanNetEval(DATASETS[dtype].CLASSES, min_npoint=10).evaluate(
        [r['pred_instances'] for r in results],
        [r['gt_instances'] for r in results], nproc=1)
    for want in (captured['res'], direct):
        for k in ('all_ap', 'all_ap_50%', 'all_ap_25%'):
            np.testing.assert_equal(mine[k], want[k], err_msg=k)
        for cls, metrics in want['classes'].items():
            for k, v in metrics.items():
                np.testing.assert_equal(mine['classes'][cls][k], v,
                                        err_msg=f'{cls} {k}')
    assert mine['all_ap_50%'] > 0


# ---------------------------------------------------------------------------
# eval_det: TestEvalDet's cases on both, and main on a saved directory
# ---------------------------------------------------------------------------

BOX = np.array([0, 0, 0, 1, 1, 1], float)


def _det_cases(mod):
    """TestEvalDet's cases run through ``mod``: their results in order."""
    a = np.array([0, 0, 0, 2, 2, 2], float)
    b = np.array([1, 1, 1, 3, 3, 3], float)
    out = [mod.box_iou_aabb(a, b), mod.box_iou_aabb(a, a),
           mod.box_iou_aabb(a, a + 10)]
    out.append(mod.voc_ap(np.array([1.0]), np.array([1.0])))
    gt = {'s0': [BOX], 's1': [BOX]}
    pred = {'s0': [(BOX, 0.9)], 's1': [(BOX + 5, 0.8)]}
    out.append(mod.eval_det_cls(pred, gt, ovthresh=0.25))
    out.append(mod.eval_det({'s0': [('chair', BOX, 0.9),
                                    ('table', BOX + 5, 0.8)]},
                            {'s0': [('chair', BOX), ('table', BOX + 5)]},
                            ovthresh=0.5))
    out.append(mod.voc_ap(np.array([0.5]), np.array([1.0]),
                          use_07_metric=True))
    out.append(mod.voc_ap(np.array([1.0]), np.array([1.0]),
                          use_07_metric=True))
    pred_all = {'s0': [('chair', BOX, 0.9)]}
    gt_all = {'s0': [('chair', BOX), ('table', BOX + 5)]}
    out.append(mod.eval_sphere(pred_all, gt_all, ovthresh=0.5))
    out.append(mod.eval_sphere(pred_all, gt_all, ovthresh=0.5,
                               use_07_metric=True))
    calls = []

    def fake_iou(x, y):
        calls.append(1)
        return 1.0 if np.allclose(x, y) else 0.0
    out.append(mod.eval_det({'s0': [('c', BOX, 0.9)]}, {'s0': [('c', BOX)]},
                            ovthresh=0.5, get_iou_func=fake_iou))
    out.append(len(calls))
    return out


def _assert_same(a, b, what=''):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _assert_same(a[k], b[k], f'{what}.{k}')
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f'{what}[{i}]')
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def test_eval_det_cases_match():
    """Every case of TestEvalDet, the same numbers from both; the cases'
    own expectations hold on the port."""
    sys.path.insert(0, REPO)
    try:
        from tools import eval_det as ref_det
    finally:
        sys.path.remove(REPO)
    got = _det_cases(port_det)
    _assert_same(got, _det_cases(ref_det))
    assert abs(got[0] - 1 / 15) < 1e-9 and got[1] == 1.0 and got[2] == 0.0
    assert got[3] == 1.0
    rec, prec, ap = got[4]
    assert rec[-1] == 0.5 and 0.4 < ap <= 0.5
    assert got[5] == {'chair': 1.0, 'table': 1.0}
    assert abs(got[6] - 6 / 11) < 1e-9 and abs(got[7] - 1.0) < 1e-9
    assert got[8][2] == {'chair': 1.0, 'table': 0}
    assert abs(got[9][2]['chair'] - 1.0) < 1e-9
    assert got[10] == {'c': 1.0} and got[11] > 0


def test_boxes_from_instances_match():
    """Boxes of RLE and dense masks (an empty one dropped)."""
    sys.path.insert(0, REPO)
    try:
        from tools import eval_det as ref_det
    finally:
        sys.path.remove(REPO)
    rng = np.random.RandomState(2)
    coords = rng.rand(100, 3).astype(np.float32)
    insts = [dict(pred_mask=rle_encode(rng.rand(100) < 0.3), label_id=3,
                  conf=0.7),
             dict(pred_mask=(rng.rand(100) < 0.2).astype(np.uint8),
                  label_id=5, conf=0.4),
             dict(pred_mask=np.zeros(100, np.uint8), label_id=1, conf=0.9)]
    got = port_det.boxes_from_instances(coords, insts)
    _assert_same(got, ref_det.boxes_from_instances(coords, insts))
    assert len(got) == 2


@pytest.mark.parametrize('metric', [[], ['--use-07-metric']])
def test_eval_det_main_matches(saved, metric, capsys, monkeypatch):
    """``main`` on a saved ScanNet directory: the reference's printed
    lines, a box for every predicted instance and gt instance."""
    _, out, results = saved['scannetv2']
    mine = port_det.main([out, '--iou', '0.25'] + metric)
    mine_text = capsys.readouterr().out
    ref = _load_tool('eval_det')
    monkeypatch.setattr(sys, 'argv', ['eval_det.py', out, '--iou', '0.25']
                        + metric)
    ref.main()
    assert mine_text == capsys.readouterr().out
    assert f'mAP@0.25 = {mine["mAP"]:.4f}' in mine_text
    assert mine['n_pred'] == sum(len(r['pred_instances']) for r in results)
    assert mine['n_gt'] == sum(len(np.unique(r['gt_instances'][
        r['gt_instances'] >= 1000])) for r in results)
    assert 0 < mine['mAP'] < 1 + 1e-9   # the 11-point sum may round up


# ---------------------------------------------------------------------------
# visualization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('task', port_vis.TASKS)
def test_coords_color_matches(saved, task):
    """Each task's points and colours on a saved directory, and the
    ``.ply`` of each, byte for byte."""
    ref = _load_tool('visualization')
    _, out, results = saved['scannetv2']
    room = results[0]['scan_id']
    xyz, color = port_vis.get_coords_color(out, room, task)
    rxyz, rcolor = ref.get_coords_color(out, room, task)
    _assert_same((xyz, color), (rxyz, rcolor))
    assert xyz.dtype == rxyz.dtype and color.dtype == rcolor.dtype
    assert xyz.shape == (400, 3) and color.shape == (400, 3)
    # one grey for the input, several colours for every other task
    assert (len(np.unique(color, axis=0)) == 1) == (task == 'input')


def test_write_ply_matches(tmp_path):
    """``write_ply`` byte for byte, on values that round at the fourth
    decimal, negative zeros and every colour byte; ``main`` writes the
    same file."""
    ref = _load_tool('visualization')
    rng = np.random.RandomState(3)
    xyz = (rng.randn(300, 3) * 3).astype(np.float32)
    xyz[:5] = [[0.00005, -0.00004, 1.23455], [-0.0, 0.0, 2.5],
               [1e-9, -1e-9, 99999.5], [0.12345, 0.56785, -7.00005],
               [3.4028e5, -1.5, 0.0]]
    color = rng.randint(0, 256, (300, 3)).astype(np.float32)
    port_vis.write_ply(str(tmp_path / 'port.ply'), xyz, color)
    ref.write_ply(str(tmp_path / 'ref.ply'), xyz, color)
    assert (tmp_path / 'port.ply').read_bytes() == \
        (tmp_path / 'ref.ply').read_bytes()
    lines = (tmp_path / 'port.ply').read_text().splitlines()
    assert lines[2] == 'element vertex 300' and len(lines) == 10 + 300


def test_visualization_main(saved, tmp_path):
    _, out, results = saved['scannetv2']
    room = results[1]['scan_id']
    path = port_vis.main(['--prediction_path', out, '--room_name', room,
                          '--task', 'instance_pred', '--out',
                          str(tmp_path / 'v.ply')])
    ref = _load_tool('visualization')
    ref.write_ply(str(tmp_path / 'r.ply'),
                  *ref.get_coords_color(out, room, 'instance_pred'))
    assert open(path, 'rb').read() == (tmp_path / 'r.ply').read_bytes()
    np.testing.assert_array_equal(
        port_util.read_mesh_vertices(path).shape, (400, 3))
