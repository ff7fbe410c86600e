"""Parity of the PyTorch port's host batch, grouping, weights and whole
``test_forward`` with the JAX reference on the CPU (the tiny config of
tests/test_model.py with ``pair_keys=False``; the JAX net runs with
``bf16=False`` and f32 matmul precision, the port on CPU tensors, so every
kernel takes its plain version).

Tolerances: host arrays, grouping and integer outputs exact; backbone and
refinement f32 outputs at rtol/atol 1e-4 (same math, other summation
order); proposals compared as point sets per proposal.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softgroup_tpu.data.padding import build_scene_batch as jax_batch
from softgroup_tpu.evaluation.postprocess import \
    get_instances as jax_get_instances
from softgroup_tpu.model.softgroup import Capacities as JCaps
from softgroup_tpu.model.softgroup import \
    forward_grouping as jax_forward_grouping
from softgroup_tpu_torch.data.padding import build_scene_batch
from softgroup_tpu_torch.evaluation.postprocess import get_instances
from softgroup_tpu_torch.model.softgroup import (Capacities, SoftGroupNet,
                                                 forward_grouping)
from softgroup_tpu_torch.util.convert import from_jax_variables

from torch_helpers import (CAPS, TINY, TINY20, batch_args, batch_arrays,
                           jax_tiny_model, logits_clear_of, tiny_cfg,
                           tiny_data)

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def data():
    return tiny_data()


@pytest.fixture(scope='module')
def batches(data):
    tb = build_scene_batch(*batch_args(data), Capacities(**CAPS),
                           num_levels=3, device='cpu')
    jb = jax_batch(*batch_args(data), JCaps(**CAPS), num_levels=3)
    return tb, jb


@pytest.fixture(scope='module')
def jax_model(batches):
    _, jb = batches
    return jax_tiny_model(jb, tiny_cfg(), JCaps(**CAPS))


def test_build_scene_batch_exact(batches):
    tb, jb = batches
    n = 0
    for name, a, b in batch_arrays(tb, jb):
        b = np.asarray(b)
        a = a.numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        n += 1
    assert n == 2 + 3 * 7 - 3 + 11


@pytest.mark.parametrize('cfg_dict', [TINY, TINY20], ids=['6cls', '20cls'])
def test_forward_grouping_exact(batches, cfg_dict):
    """Identical scores/offsets in -> identical CSR proposals out; the
    20-class case (score_thr 0.2) runs the per-point top-k branch."""
    tb, jb = batches
    cfg = tiny_cfg(cfg_dict)
    n_cls = cfg.semantic_classes
    p = CAPS['points']
    rng = np.random.RandomState(n_cls)
    sem = logits_clear_of(rng, p, n_cls, cfg.grouping_cfg.score_thr)
    # favour two thing classes so their classes clear the thresholds
    sem[:, 2:4] += 1.5
    off = (rng.randint(-3, 4, (p, 3)) / 64).astype(np.float32)
    caps_j, caps_t = JCaps(**CAPS), Capacities(**CAPS)
    ref = jax_forward_grouping(
        jnp.asarray(sem), jnp.asarray(off), jb.batch_idxs, jb.coords_float,
        jb.pyramid.point_valid, cfg, caps_j)
    out = forward_grouping(torch.from_numpy(sem), torch.from_numpy(off),
                           tb.batch_idxs, tb.coords_float,
                           tb.pyramid.point_valid, cfg, caps_t)
    assert int(ref.n_proposals) > 2
    for f in ('entry_pt', 'entry_seg', 'entry_valid', 'n_proposals',
              'prop_valid'):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_from_jax_variables_round_trip(jax_model):
    _, variables = jax_model
    state = from_jax_variables(variables)
    net = SoftGroupNet(channels=8, num_blocks=3, semantic_classes=6,
                       instance_classes=4, bf16=False)
    missing = net.load_state_dict(state, strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    flat = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    assert len(flat) == len(state) == len(net.state_dict())
    for path, leaf in flat.items():
        key = '.'.join(p.key for p in path[1:])
        np.testing.assert_array_equal(net.state_dict()[key].numpy(),
                                      np.asarray(leaf), err_msg=key)


@pytest.fixture(scope='module')
def forwards(batches, jax_model):
    tb, jb = batches
    jnet, variables = jax_model
    cfg = tiny_cfg()
    ref = jax.jit(lambda v, b: jnet.apply(v, b, cfg, JCaps(**CAPS),
                                          method=jnet.test_forward))(
        variables, jb)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    net = SoftGroupNet(channels=8, num_blocks=3, semantic_classes=6,
                       instance_classes=4, bf16=False)
    net.load_state_dict(from_jax_variables(variables))
    out = net.eval().test_forward(tb, cfg, Capacities(**CAPS))
    out = {k: v.numpy() for k, v in out.items()}
    return out, ref


def _proposal_sets(o):
    ev = o['entry_valid']
    props = {}
    for s, pt in zip(o['entry_seg'][ev], o['entry_pt'][ev]):
        props.setdefault(int(s), []).append(int(pt))
    return {s: sorted(v) for s, v in props.items()}


def test_test_forward_backbone(forwards):
    out, ref = forwards
    for k in ('semantic_scores', 'pt_offsets'):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(out['semantic_preds'],
                                  ref['semantic_preds'])


def test_test_forward_proposals(forwards):
    out, ref = forwards
    assert int(ref['n_proposals']) > 0
    assert int(out['n_proposals']) == int(ref['n_proposals'])
    assert _proposal_sets(out) == _proposal_sets(ref)
    for k in ('entry_pt', 'entry_seg', 'entry_valid'):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_test_forward_refinement(forwards):
    out, ref = forwards
    for k in ('cls_scores', 'iou_scores', 'mask_scores'):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_test_forward_odd_spatial_shape(batches, jax_model, monkeypatch):
    """An odd ``instance_voxel_cfg.spatial_shape`` (9) at inference: the
    refinement U-Net runs on rulebook levels (K7 rules, K1 convs), as the
    reference's does; the same proposals, and cls / mask / iou scores
    within rtol / atol 1e-4 of the reference's."""
    from softgroup_tpu_torch.model import softgroup as sg
    tb, jb = batches
    jnet, variables = jax_model
    cfg = tiny_cfg(dict(TINY, instance_voxel_cfg=dict(scale=10,
                                                      spatial_shape=9)))
    ref = jax.jit(lambda v, b: jnet.apply(v, b, cfg, JCaps(**CAPS),
                                          method=jnet.test_forward))(
        variables, jb)
    net = SoftGroupNet(channels=8, num_blocks=3, semantic_classes=6,
                       instance_classes=4, bf16=False)
    net.load_state_dict(from_jax_variables(variables))
    built = []

    def pyramid(*a, _f=sg.build_pyramid_from_voxels):
        built.append(a[2])
        return _f(*a)
    monkeypatch.setattr(sg, 'build_pyramid_from_voxels', pyramid)
    out = net.eval().test_forward(tb, cfg, Capacities(**CAPS))
    assert built == [(9, 9, 9)]
    out = {k: v.numpy() for k, v in out.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert int(ref['n_proposals']) > 0
    for k in ('entry_pt', 'entry_seg', 'entry_valid', 'n_proposals'):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    for k in ('cls_scores', 'iou_scores', 'mask_scores'):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_clusters_voxelization_on_cell_edges():
    """The proposal voxels of ``clusters_voxelization`` equal the
    reference's (jitted, where XLA divides ``extent / spatial_shape`` as a
    product with the f32 reciprocal) on proposals whose extent's true f32
    quotient is an ulp off that product, with points on the cell edges
    where the two quotients floor apart: p2v and the voxel features exact
    (each voxel here holds one point)."""
    from softgroup_tpu.model.softgroup import Proposals as JProposals
    from softgroup_tpu.model.softgroup import \
        clusters_voxelization as jax_clusters_voxelization
    from softgroup_tpu_torch.model import softgroup as sg
    shape, scale = 20, 50.0
    f32 = np.float32
    inv = f32(1) / f32(shape)

    def scales(e):
        return (f32(1) / (e / f32(shape)) - f32(0.01),
                f32(1) / (e * inv) - f32(0.01))
    rs = np.random.RandomState(0)
    coords, seg, parted = [], [], 0
    for e in rs.uniform(0.5, 4.0, 512).astype(f32):
        s_true, s_rec = scales(e)
        if s_true == s_rec:
            continue
        # x where floor(x * scale) parts between the two scales
        xs = [x for k in range(1, shape) for x in
              f32(k / s_rec) + f32(k / s_rec) * f32(2 ** -23) * np.arange(
                  -4, 5, dtype=f32)
              if 0 < x < e and np.floor(x * s_true) != np.floor(x * s_rec)]
        if not xs:
            continue
        p = len(set(seg)) if seg else 0
        pts = [(0, 0, 0), (e, 0, 0)] + [(x, 0, 0) for x in xs[:2]]
        coords += pts
        seg += [p] * len(pts)
        parted += len(xs[:2])
        if p + 1 == 16:
            break
    assert parted >= 16
    n, p_max, s_cap = len(coords), 16, 128
    coords = np.asarray(coords, f32)
    feats = rs.standard_normal((n, 8)).astype(f32)
    entry_pt = np.zeros(s_cap, np.int32)
    entry_pt[:n] = np.arange(n)
    entry_seg = np.full(s_cap, p_max, np.int32)
    entry_seg[:n] = seg
    valid = np.arange(s_cap) < n
    caps = dict(CAPS, inst_voxels=(128, 64))

    def props(m, t):
        return m(t(entry_pt), t(entry_seg), t(valid), t(np.int32(p_max)),
                 t(np.ones(p_max, bool)))
    ref = jax.jit(lambda pr, f, c: jax_clusters_voxelization(
        pr, f, c, scale, shape, JCaps(**caps)))(
        props(JProposals, jnp.asarray), jnp.asarray(feats),
        jnp.asarray(coords))
    out = sg.clusters_voxelization(
        props(sg.Proposals, torch.as_tensor), torch.from_numpy(feats),
        torch.from_numpy(coords), scale, shape, Capacities(**caps))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    # voxel_parity's cells: the product's cells are the port's voxels, and
    # the true quotient moves exactly the edge points
    from softgroup_tpu_torch.voxel_parity import cells
    tp, xyz = props(sg.Proposals, torch.as_tensor), torch.from_numpy(coords)
    no_rand = torch.zeros((2, 3))
    prod = cells(tp, xyz, scale, shape, no_rand, False)[:n].long()
    quot = cells(tp, xyz, scale, shape, no_rand, True)[:n].long()
    assert int((prod != quot).any(dim=1).sum()) == parted
    key = torch.as_tensor(seg) * shape ** 3 + (
        prod * torch.tensor([shape ** 2, shape, 1])).sum(dim=1)
    p2v = out[2][:n].long()
    assert len(torch.unique(key)) == len(torch.unique(p2v)) == len(
        torch.unique(key * caps['inst_voxels'][0] + p2v))


def test_get_instances_matches(forwards, batches):
    out, _ = forwards
    tb, _ = batches
    cfg = tiny_cfg()
    n = int(tb.pyramid.point_valid.sum())
    mine = get_instances('s', out, n, cfg)
    theirs = jax_get_instances('s', out, n, cfg)
    assert mine == theirs and len(mine) > 0


def test_port_imports_no_jax():
    """The port and every submodule load without JAX or softgroup_tpu."""
    code = (
        'import importlib, pkgutil, sys\n'
        'import softgroup_tpu_torch as p\n'
        'for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in\n'
        '       ("jax", "jaxlib", "flax", "softgroup_tpu")]\n'
        'assert not bad, bad\n'
        'for name in ("entry", "ops.native", "tools_impl.test_runner",\n'
        '             "data.s3dis", "evaluation.instance_eval",\n'
        '             "data.kitti", "evaluation.panoptic_eval",\n'
        '             "util.checkpoint", "util.logger",\n'
        '             "tools_impl.test_cli", "tools_impl.train_cli",\n'
        '             "util.optim", "train", "ops.grouping",\n'
        '             "model.softgroup", "data.stpls3d", "time_kernels",\n'
        '             "parallel.ddp", "evaluation.instance_eval_util",\n'
        '             "tools_impl.eval_saved", "tools_impl.eval_det",\n'
        '             "tools_impl.visualization"):\n'
        '    assert "softgroup_tpu_torch." + name in sys.modules, name\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, '-c', code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


# modules of the reference with no counterpart module in the port, and why
NOT_PORTED = {
    'softgroup_tpu/csrc/build.py': 'the native host library build: the '
    'port builds its own csrc/hostops.cpp (ops/native.py) and its CUDA '
    'kernels (ops/kernels.py)',
    'softgroup_tpu/ops/dispatch.py': 'TPU dispatch (Pallas vs XLA paths by '
    'backend); a port wrapper dispatches on its tensor\'s device',
    'softgroup_tpu/ops/keys.py': 'key packing, inlined into the modules '
    'that use it: ops/voxelize.py, ops/rulebook.py, ops/grouping.py, '
    'ops/join_kernel.py',
    'tools/convert_checkpoint.py': 'the port\'s util/checkpoint.load_weights '
    'reads a reference .pth directly',
}
# the reference's window plans (``window_rules*``, ``WindowMeta``,
# ``subm_plan`` / ``down_plan``) live inside ops/conv_kernel.py and
# ops/rulebook.py, which have counterparts; the plans themselves are TPU
# cost-model workarounds and are not ported (ROADMAP.md)
TPU_HARNESSES = (
    'bench_ablate', 'bench_ap', 'bench_breakdown', 'bench_cv',
    'bench_s3dis', 'bench_train', 'bench_train_batch4',
    'bench_train_breakdown', 'check_hw_parity', 'compare_grouping',
    'compare_x4split', 'microbench_conv', 'microbench_convk', 'occupancy',
    'profile_infer', 'profile_train', 'sweep_convbw', 'sweep_convdw')
NOT_PORTED.update({
    f'tools/{name}.py': 'a benchmark, sweep or diagnosis harness of the '
    'JAX package on a TPU; the port measures with chip_smoke.py, '
    'time_kernels.py and portbench/'
    for name in TPU_HARNESSES})
# reference modules whose counterpart has another name
RENAMED = {
    'softgroup_tpu/parallel/mesh.py': 'parallel/ddp.py',
    'tools/test.py': 'tools_impl/test_cli.py',
    'tools/train.py': 'tools_impl/train_cli.py',
    'tools/eval_saved.py': 'tools_impl/eval_saved.py',
    'tools/eval_det.py': 'tools_impl/eval_det.py',
    'tools/visualization.py': 'tools_impl/visualization.py',
}


def test_every_reference_module_has_a_counterpart():
    """Every module of ``softgroup_tpu/`` and every user tool of
    ``tools/`` has a counterpart module in ``softgroup_tpu_torch/`` (the
    same path, or the one ``RENAMED`` names) or a reason in
    ``NOT_PORTED``; every entry of both maps names a file that exists."""
    import glob
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = os.path.join(root, 'softgroup_tpu_torch')
    ref = sorted(os.path.relpath(f, root) for f in glob.glob(
        os.path.join(root, 'softgroup_tpu', '**', '*.py'), recursive=True))
    tools = sorted(os.path.relpath(f, root) for f in glob.glob(
        os.path.join(root, 'tools', '*.py')))
    assert len(ref) > 40 and 'tools/train.py' in tools
    missing = []
    for rel in ref + tools:
        if rel in NOT_PORTED:
            assert NOT_PORTED[rel], rel
            continue
        mine = RENAMED.get(rel, rel.split('/', 1)[1])
        if not os.path.isfile(os.path.join(port, mine)):
            missing.append(rel)
    assert not missing, missing
    for rel in list(NOT_PORTED) + list(RENAMED):
        assert os.path.isfile(os.path.join(root, rel)), rel
    assert not set(NOT_PORTED) & set(RENAMED)


def test_time_kernels_finds_chip_smoke_cases():
    """The K1 / K2 cases that ``chip_smoke.py`` and ``time_kernels`` time
    are picked from a recorded request of the flagship net (bf16, every
    level): each is found at the shapes named, and the recorder puts the
    wrappers back."""
    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.data.synthetic import make_scene
    from softgroup_tpu_torch.model import softgroup as sg
    from softgroup_tpu_torch.ops import conv_kernel, gather_kernel
    from softgroup_tpu_torch.ops import grouping, sparse_conv
    from softgroup_tpu_torch.model import blocks
    from softgroup_tpu_torch.time_kernels import (Recorder, k1_k2_args,
                                                  k4_args)
    caps = Capacities(
        points=16384, voxels=(16384, 8192, 4096, 2048, 1024, 512, 256),
        grouping_points=32768, proposals=32, proposal_entries=32768,
        instances=32, inst_voxels=(8192, 2048), grouping_cells=4096)
    cfg = entry.flagship_cfg()
    net = entry.build_net(cfg, seed=1, device='cpu', bf16=True)
    with torch.no_grad():   # lift two classes over score_thr, as chip_smoke
        net.semantic_linear.final_bias[2:4] = 2.5
    batch = entry.build_batch(make_scene(np.random.RandomState(7),
                                         n_points=8000, n_instances=6),
                              cfg, caps, device='cpu')
    sites = [(sparse_conv, 'rulebook_conv'), (gather_kernel, 'row_gather'),
             (grouping, 'row_gather'), (sg, 'row_gather'),
             (blocks, 'keyed_conv')]
    with Recorder(sites) as rec:
        entry.infer(net, batch, cfg, caps)
    assert sparse_conv.rulebook_conv is conv_kernel.rulebook_conv
    assert grouping.row_gather is gather_kernel.row_gather
    assert blocks.keyed_conv is conv_kernel.keyed_conv
    keyed = k4_args(rec.calls['keyed_conv'])
    (a, kw), (b, kwb) = keyed['K4 subm D=20 32->32'], \
        keyed['K4 down D=10 32->64']
    assert not kw['strided'] and a[2] is a[3] and a[4] == 20   # one table
    assert a[0].shape == (caps.inst_voxels[0], 32)
    assert kwb['strided'] and b[1].shape == (8, 32, 64)
    cases = k1_k2_args(rec.calls, caps.voxels[0], caps.grouping_cells)
    assert len(cases) == 10
    feats, w, rules = cases['K1 L0 subm 32->32']
    assert feats.shape == (16384, 32) and rules.shape == (27, 16384)
    assert cases['K1 L5 tail 384->192'][1].shape == (27, 384, 192)
    src, idx = cases['K2 cell labels (m+1,) int32']
    assert src.shape == (4097,) and idx.dim() == 1


def test_time_kernels_finds_plus_cases():
    """The SoftGroup++ request's K1 / K2 / K4 cases that ``chip_smoke.py``
    holds against their plain versions are picked from a recorded request
    through the runner (the ++ ScanNet net, bf16, every level) at its
    bucketed caps: the heads gather of (V0, 23) f32 rows among them."""
    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.data.synthetic import collate_scenes, make_scene
    from softgroup_tpu_torch.model import softgroup as sg
    from softgroup_tpu_torch.ops import gather_kernel, grouping, sparse_conv
    from softgroup_tpu_torch.model import blocks
    from softgroup_tpu_torch.time_kernels import Recorder, request_args
    base = Capacities(
        points=16384, voxels=(16384, 8192, 4096, 2048, 1024, 512, 256),
        grouping_points=32768, proposals=32, proposal_entries=32768,
        instances=32, inst_voxels=(8192, 2048), grouping_cells=4096)
    cfg = entry.plus_cfg()
    net = entry.build_net(cfg, seed=1, device='cpu', bf16=True)
    with torch.no_grad():   # lift two classes over score_thr, as chip_smoke
        net.semantic_linear.final_bias[2:4] = 2.5
    runner = entry.build_runner(net, cfg, base, device='cpu')
    data = collate_scenes([make_scene(np.random.RandomState(7),
                                      n_points=8000, n_instances=6)],
                          scale=50.0)
    data['scan_ids'] = ['s7']
    sites = [(sparse_conv, 'rulebook_conv'), (gather_kernel, 'row_gather'),
             (grouping, 'row_gather'), (sg, 'row_gather'),
             (blocks, 'keyed_conv')]
    stats = {}
    with Recorder(sites) as rec:
        runner.run_scene(data, stats=stats)
    caps = stats['caps']
    assert caps.voxels[0] < base.voxels[0]   # bucketed on the scan
    cases = request_args(rec.calls, caps, '++', cfg.semantic_classes + 3)
    assert [k.split(' ')[0] for k in cases] == ['K1'] * 2 + ['K2'] * 3 \
        + ['K4'] * 2
    v0 = caps.voxels[0]
    (feats, w, rules), _ = cases[f'K1 ++ L0 subm 32->32 bf16 (V0={v0})']
    assert feats.shape == (v0, 32) and rules.shape == (27, v0)
    (src, idx), _ = cases[f'K2 ++ heads (V0, 23) f32 (V0={v0})']
    assert src.shape == (v0, 23) and idx.shape == (caps.points,)
    (src, idx), _ = cases[f'K2 ++ grouping entries (V0, 4) f32 -> '
                          f'P={caps.grouping_points}']
    assert src.shape == (v0, 4) and idx.shape == (caps.grouping_points,)
    (a, kw) = cases['K4 ++ subm D=20 32->32']
    assert not kw['strided'] and a[0].shape == (base.inst_voxels[0], 32)


def test_time_kernels_finds_k5_cases():
    """The K5 census and cases of ``time_kernels`` / ``chip_smoke.py`` are
    picked from one recorded all-params train step of the flagship training
    config (every level, small capacities): 79 calls in 24 shapes, each
    labelled by its level, and every ``chip_smoke.py`` case found."""
    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.data.synthetic import make_scene
    from softgroup_tpu_torch.ops import conv_kernel, sparse_conv
    from softgroup_tpu_torch.time_kernels import (Recorder, k5_args,
                                                  k5_census)
    caps = Capacities(
        points=16384, voxels=(16384, 8192, 4096, 2048, 1024, 512, 256),
        grouping_points=32768, proposals=32, proposal_entries=32768,
        instances=32, inst_voxels=(4096, 1024), grouping_cells=4096)
    cfg = entry.train_cfg()
    net = entry.build_net(cfg, seed=1, device='cpu', bf16=True)
    state = entry.build_train_state(net, cfg, caps)
    batch = entry.build_train_batch(
        [make_scene(np.random.RandomState(7), n_points=8000,
                    n_instances=6)], cfg, caps, device='cpu')
    with Recorder([(sparse_conv, 'rulebook_conv_dw')]) as rec:
        state.step(batch, generator=torch.Generator().manual_seed(0))
    assert sparse_conv.rulebook_conv_dw is conv_kernel.rulebook_conv_dw
    calls = rec.calls['rulebook_conv_dw']
    census = k5_census(calls, caps)
    assert sum(c['launches'] for c in census) == len(calls) == 79
    labels = {c['label']: c for c in census}
    assert len(labels) == len(census) == 24
    assert labels['L2 subm']['shape'] == (27, 4096, 96, 96)
    assert labels['L2 subm']['launches'] == 7
    assert labels['L0 input']['shape'] == (27, 16384, 6, 32)
    assert labels['L5->L6 down/up']['launches'] == 2
    assert labels['tiny L1 subm']['shape'] == (27, 1024, 64, 64)
    cases = k5_args(calls, caps)
    assert len(cases) == 7
    feats, g, rules = cases['L1 subm 64->64']
    assert rules.shape == (27, 8192) and feats.shape[1] == g.shape[1] == 64
    assert cases['L5 tail 384->192'][0].shape[1] == 384


def test_time_kernels_k6_k7_census(monkeypatch, capsys):
    """The K6 and K7 censuses of ``time_kernels`` on one recorded all-params
    train step of the flagship training config (small capacities, plain
    versions on the CPU, the timer stubbed): the three K6 call sites of
    the step by width and the two K7 levels, each with its run or window
    figures, plus the trained-fill cases: K6 runs of 1-16 rows and no
    dustbin, K7 full 20^3 grids."""
    from softgroup_tpu_torch import entry, time_kernels as tk
    from softgroup_tpu_torch.data.synthetic import make_scene
    from softgroup_tpu_torch.ops import gather_kernel, join_kernel, rulebook
    from softgroup_tpu_torch.time_kernels import Recorder
    caps = Capacities(
        points=16384, voxels=(16384, 8192, 4096, 2048, 1024, 512, 256),
        grouping_points=32768, proposals=32, proposal_entries=32768,
        instances=32, inst_voxels=(4096, 1024), grouping_cells=4096)
    cfg = entry.train_cfg()
    net = entry.build_net(cfg, seed=1, device='cpu', bf16=True)
    state = entry.build_train_state(net, cfg, caps)
    batch = entry.build_train_batch(
        [make_scene(np.random.RandomState(7), n_points=8000,
                    n_instances=6)], cfg, caps, device='cpu')
    with Recorder([(gather_kernel, 'sorted_segment_sum'),
                   (rulebook, 'sorted_key_rules_join')]) as rec:
        state.step(batch, generator=torch.Generator().manual_seed(0))
    assert rulebook.sorted_key_rules_join is join_kernel.sorted_key_rules_join
    seg_calls = rec.calls['sorted_segment_sum']
    assert sorted(tk.K6_SITES[a[0].shape[1]] for a, _ in seg_calls) == [
        'devoxelize backward', 'mask-gather backward',
        'proposal-gather backward']
    assert all(kw['out_dtype'] == a[0].dtype for a, kw in seg_calls
               if a[0].dtype == torch.bfloat16)
    monkeypatch.setattr(tk, '_timed', lambda *a, **k: 1.0)
    tk.k6_census(seg_calls, 't', 'cpu', [None], device='cpu')
    tk.k7_census(rec.calls['sorted_key_rules_join'], 't', 'cpu', [None],
                 device='cpu')
    out = capsys.readouterr().out
    assert 'K6 census: 3 launches, sum of launches x device_ms = 3.0' in out
    assert 'K7 census: 2 launches, sum of launches x device_ms = 2.0' in out
    vals, seg, s = tk.k6_trained_fill('cpu')
    longest, share = tk.run_lengths(seg, 256)
    assert vals.shape == (524288, 19) and vals.dtype == torch.bfloat16
    assert longest == 16 and share == 0.0 and s == 131072
    assert bool((seg[1:] > seg[:-1]).sum() > 30000)
    keys, xyz, dims, offs = tk.k7_trained_fill('cpu')
    rules = join_kernel.sorted_key_rules_join_plain(keys, xyz, dims, offs)
    assert keys.shape == (131072,) and len(offs) == 26
    assert int((rules >= 0).sum()) > 20 * 131072
    (b_ms, b_by) = tk.segsum_bound(vals, seg, s, torch.bfloat16)
    assert b_by == 'bytes' and b_ms == pytest.approx(
        (524288 * 19 * 2 + 524288 * 4 + 131072 * 19 * 2) / 3.35e12 * 1e3)


def test_time_kernels_k3_census(monkeypatch, capsys):
    """K3's census of ``time_kernels`` on the join call of one recorded
    request of the flagship net (small capacities, the plain version on the
    CPU, the timer stubbed): its line has m, the valid cells, ``dims``, the
    hits and gated-in queries and each dx group's key windows at every
    tile size, which agree with a count over the tiles by hand."""
    from softgroup_tpu_torch import entry, time_kernels as tk
    from softgroup_tpu_torch.data.synthetic import make_scene
    from softgroup_tpu_torch.ops import grouping, join_kernel
    from softgroup_tpu_torch.time_kernels import Recorder
    caps = Capacities(
        points=16384, voxels=(16384, 8192, 4096, 2048, 1024, 512, 256),
        grouping_points=32768, proposals=32, proposal_entries=32768,
        instances=32, inst_voxels=(8192, 2048), grouping_cells=4096)
    cfg = entry.flagship_cfg()
    net = entry.build_net(cfg, seed=1, device='cpu', bf16=True)
    with torch.no_grad():   # lift two classes over score_thr, as chip_smoke
        net.semantic_linear.final_bias[2:4] = 2.5
    batch = entry.build_batch(make_scene(np.random.RandomState(7),
                                         n_points=8000, n_instances=6),
                              cfg, caps, device='cpu')
    with Recorder([(grouping, 'cell_neighbor_join')]) as rec:
        entry.infer(net, batch, cfg, caps)
    assert grouping.cell_neighbor_join is join_kernel.cell_neighbor_join
    (args, _), = rec.calls['cell_neighbor_join']
    keys, cen, cc, dims, offs, radius = args
    assert keys.shape == (4096,) and len(offs) == 26
    monkeypatch.setattr(tk, '_timed', lambda *a, **k: 1.0)
    tk.k3_census([('request m=4096', args, 1)], 't', 'cpu', [None],
                 device='cpu')
    out = capsys.readouterr().out
    valid = int((keys != 2 ** 31 - 1).sum())
    assert f'K3 census request m=4096 m=4096 valid_cells={valid} ' in out
    assert f'dims={[int(v) for v in dims]}' in out
    assert 'K3 census: 1 launches, sum of launches x device_ms = 1.0' in out
    gated = int((join_kernel.cell_neighbor_join_plain(*args) >= 0).sum())
    assert f'gated_in={gated} ' in out and gated > 0
    k = keys.numpy().astype(np.int64)
    d = [int(v) for v in dims]
    dl = (offs[:, 0].astype(np.int64) * d[1] + offs[:, 1]) * d[2] + offs[:, 2]
    for tile in tk.JOIN_TILES:
        assert f'windows_t{tile}=dx-1:' in out
        wins = tk.k3_windows(keys, dims, offs, tile)
        assert [w[0] for w in wins] == [-1, 0, 1]
        for dx, largest, mean in wins:
            sel = dl[offs[:, 0] == dx]
            counts = []
            for t0 in range(0, len(k), tile):
                kt = k[t0:t0 + tile]
                kt = kt[kt != 2 ** 31 - 1]
                if len(kt):
                    counts.append(int(((k >= kt[0] + sel.min())
                                       & (k <= kt[-1] + sel.max())).sum()))
            assert largest == max(counts)
            assert mean == pytest.approx(np.mean(counts))
