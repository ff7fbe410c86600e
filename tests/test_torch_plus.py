"""Parity of the port's SoftGroup++ inference with the JAX reference on the
CPU: ``round_capacity`` / ``bucketed_caps``, ``voxel_features`` (pad rows
present), ``backbone_voxel_heads``, ``forward_grouping`` with the scene
pyramid (levels 1, 2 and 3 all taken), the whole ``test_forward_plus``,
``get_gt_instances``, ``get_instances`` on voxel masks and the inference
runner's ``run_scene`` with lvl_fusion on and off (the tiny config of
tests/test_model.py, ``pair_keys=False``; the JAX net with ``bf16=False``
and f32 matmuls, the port on CPU tensors: every kernel takes its plain
version).

Tolerances: host arrays, integer outputs and proposals exact (proposals as
voxel / point sets per proposal); f32 heads and scores rtol / atol 1e-4.
Coordinates sit on a 1/64 grid, so the f32 voxel means are exact on both
sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softgroup_tpu.data.padding import build_scene_batch as jax_batch
from softgroup_tpu.data.padding import round_capacity as jax_round_capacity
from softgroup_tpu.evaluation.postprocess import \
    get_gt_instances as jax_get_gt_instances
from softgroup_tpu.evaluation.postprocess import \
    get_instances as jax_get_instances
from softgroup_tpu.model.softgroup import Capacities as JCaps
from softgroup_tpu.model.softgroup import \
    forward_grouping as jax_forward_grouping
from softgroup_tpu.ops.voxelize import voxel_features as jax_voxel_features
from softgroup_tpu.tools_impl.test_runner import \
    InferenceRunner as JaxRunner
from softgroup_tpu.tools_impl.test_runner import \
    bucketed_caps as jax_bucketed_caps
from softgroup_tpu.util.config import load_config as jax_load_config
from softgroup_tpu_torch import entry
from softgroup_tpu_torch.data.padding import build_scene_batch, round_capacity
from softgroup_tpu_torch.evaluation.postprocess import (get_gt_instances,
                                                        get_instances)
from softgroup_tpu_torch.model.softgroup import (Capacities, SoftGroupNet,
                                                 class_active_counts,
                                                 forward_grouping,
                                                 pyramid_levels)
from softgroup_tpu_torch.ops.voxelize import voxel_features
from softgroup_tpu_torch.tools_impl.test_runner import (InferenceRunner,
                                                        bucketed_caps)
from softgroup_tpu_torch.util.convert import from_jax_variables

from torch_helpers import (CAPS, PLUS, TINY, batch_args, batch_arrays,
                           jax_tiny_model, tiny_cfg, tiny_data)

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def data():
    d = tiny_data()
    d['scan_ids'] = ['tiny']
    return d


@pytest.fixture(scope='module')
def batches(data):
    tb = build_scene_batch(*batch_args(data), Capacities(**CAPS),
                           num_levels=3, device='cpu')
    jb = jax_batch(*batch_args(data), JCaps(**CAPS), num_levels=3)
    return tb, jb


@pytest.fixture(scope='module')
def models(batches):
    _, jb = batches
    jnet, variables = jax_tiny_model(jb, tiny_cfg(), JCaps(**CAPS))
    net = SoftGroupNet(channels=8, num_blocks=3, semantic_classes=6,
                       instance_classes=4, bf16=False)
    net.load_state_dict(from_jax_variables(variables))
    return jnet, variables, net.eval()


@pytest.mark.parametrize('n', [1, 255, 1024, 1025, 3000, 188006, 250000,
                               1048577])
@pytest.mark.parametrize('minimum', [1024, 256])
def test_round_capacity_matches(n, minimum):
    assert round_capacity(n, minimum=minimum) == \
        jax_round_capacity(n, minimum=minimum)


@pytest.mark.parametrize('lvl_fusion', [True, False], ids=['plus', 'plain'])
@pytest.mark.parametrize('n_points,counts', [
    (3000, [2037, 1100, 400]),
    (250000, [188006, 98000, 31000, 7900, 2000, 600, 200]),
    (900000, [851000, 400000, 120000, 60000, 16000, 8000, 4000])])
def test_bucketed_caps_matches(lvl_fusion, n_points, counts):
    base = entry.bench_capacities()
    jbase = JCaps(**base._asdict())
    got = bucketed_caps(n_points, counts, base, lvl_fusion=lvl_fusion)
    want = jax_bucketed_caps(n_points, counts, jbase, lvl_fusion=lvl_fusion)
    assert got._asdict() == want._asdict()
    assert got.grouping_cells == 65536


def test_voxel_features_drops_pad_rows(batches):
    """Pad rows carry p2v = the capacity and values far off the scene's:
    they fall into the dustbin, not into the last voxel's mean."""
    tb, _ = batches
    v0 = CAPS['voxels'][0]
    p2v = tb.pyramid.p2v
    valid = tb.pyramid.point_valid
    assert (p2v[~valid] == v0).all() and (~valid).any()
    vals = torch.cat([tb.coords_float, tb.feats], dim=1)
    vals[~valid] = 1000.0
    got = voxel_features(vals, p2v, v0).numpy()
    want = np.asarray(jax_voxel_features(jnp.asarray(vals.numpy()),
                                         jnp.asarray(p2v.numpy()), v0))
    np.testing.assert_array_equal(got, want)
    last = int(p2v[valid].max())
    sel = (p2v == last) & valid
    np.testing.assert_array_equal(got[last], vals[sel].numpy().mean(0))
    assert np.abs(got).max() < 1000.0


def test_input_voxels_fallback(batches, models):
    """A batch without ``vox_in``: the network input is averaged on the
    device, as the reference's ``_input_voxels`` fallback, and the
    backbone gives what it gives on the host-built input."""
    tb, _ = batches
    _, _, net = models
    cfg = tiny_cfg()
    nb = dataclasses.replace(tb, vox_in=None)
    x = net._input_voxels(nb, cfg)
    v0 = CAPS['voxels'][0]
    want = np.asarray(jax_voxel_features(
        jnp.concatenate([jnp.asarray(tb.feats.numpy()),
                         jnp.asarray(tb.coords_float.numpy())], axis=1),
        jnp.asarray(tb.pyramid.p2v.numpy()), v0))
    np.testing.assert_array_equal(x.numpy(), want)
    np.testing.assert_allclose(x.numpy(), tb.vox_in.numpy(), rtol=1e-6,
                               atol=1e-6)
    with torch.no_grad():
        a = net.backbone(x, tb.pyramid)[0].numpy()
        b = net.backbone(tb.vox_in, tb.pyramid)[0].numpy()
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_backbone_voxel_heads_matches(batches, models):
    tb, jb = batches
    jnet, variables, net = models
    ref = jax.jit(lambda v, x, pyr: jnet.apply(
        v, x, pyr, False, method=jnet.backbone_voxel_heads))(
            variables, jb.vox_in, jb.pyramid)
    with torch.no_grad():
        out = net.backbone_voxel_heads(tb.vox_in, tb.pyramid)
    valid = tb.pyramid.levels[0].vox_valid.numpy()
    for name, a, b in zip(('semantic', 'offsets', 'features'), out, ref):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a[valid], b[valid], rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def _pyramid_logits(tb, rng):
    """(P, 6) logits: class 0 (ignored) leads everywhere except on chosen
    points of four instances, where class 2 (every point of two
    instances), 3 (40 points) or 4 (15 points) leads; every softmax score
    stays >= 0.05 away from score_thr 0.1."""
    p = tb.coords_float.shape[0]
    sem = (rng.randn(p, 6) * 0.1).astype(np.float32)
    sem[:, 0] += 3.0
    inst = tb.instance_labels.numpy()
    ids = [i for i in np.unique(inst) if i >= 0
           and (inst == i).sum() >= 60]
    rows = {i: np.nonzero(inst == i)[0] for i in ids}
    sem[np.concatenate([rows[ids[0]], rows[ids[1]]]), 2] += 6.0
    sem[rows[ids[2]][:40], 3] += 6.0
    sem[rows[ids[3]][:15], 4] += 6.0
    return sem


def test_forward_grouping_pyramid_levels_exact(batches):
    """Identical scores / offsets in -> identical proposals out, with the
    scene pyramid at thresholds (20, 60): class 4 stays at level 1, class 3
    takes level 2 and class 2 level 3 (its coordinates divided by 3)."""
    tb, jb = batches
    cfg = tiny_cfg(dict(PLUS, grouping_cfg=dict(
        PLUS['grouping_cfg'], pyramid_thresholds=(20, 60))))
    rng = np.random.RandomState(11)
    sem = _pyramid_logits(tb, rng)
    p = sem.shape[0]
    off = (rng.randint(-3, 4, (p, 3)) / 64).astype(np.float32)
    counts = class_active_counts(torch.from_numpy(sem),
                                 tb.pyramid.point_valid, cfg.grouping_cfg)
    levels = pyramid_levels(counts, cfg.grouping_cfg)
    live = counts >= cfg.test_cfg.min_npoint
    assert levels[live].tolist() == [3.0, 2.0, 1.0]
    ref = jax_forward_grouping(
        jnp.asarray(sem), jnp.asarray(off), jb.batch_idxs, jb.coords_float,
        jb.pyramid.point_valid, cfg, JCaps(**CAPS))
    out = forward_grouping(torch.from_numpy(sem), torch.from_numpy(off),
                           tb.batch_idxs, tb.coords_float,
                           tb.pyramid.point_valid, cfg, Capacities(**CAPS))
    assert int(ref.n_proposals) >= 3
    for f in ('entry_pt', 'entry_seg', 'entry_valid', 'n_proposals',
              'prop_valid'):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    # the levels change the grouping: without them the proposals differ
    flat = tiny_cfg(dict(TINY))
    plain = forward_grouping(torch.from_numpy(sem), torch.from_numpy(off),
                             tb.batch_idxs, tb.coords_float,
                             tb.pyramid.point_valid, flat,
                             Capacities(**CAPS))
    assert not torch.equal(plain.entry_seg, out.entry_seg)


@pytest.fixture(scope='module')
def forwards(batches, models):
    tb, jb = batches
    jnet, variables, net = models
    cfg = tiny_cfg(PLUS)
    ref = jax.jit(lambda v, b: jnet.apply(v, b, cfg, JCaps(**CAPS),
                                          method=jnet.test_forward_plus))(
        variables, jb)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = net.test_forward_plus(tb, cfg, Capacities(**CAPS))
    out = {k: v.numpy() for k, v in out.items()}
    return out, ref


def _proposal_sets(o):
    ev = o['entry_valid']
    props = {}
    for s, pt in zip(o['entry_seg'][ev], o['entry_pt'][ev]):
        props.setdefault(int(s), []).append(int(pt))
    return {s: sorted(v) for s, v in props.items()}


def test_forward_plus_heads(forwards):
    out, ref = forwards
    for k in ('semantic_scores', 'pt_offsets'):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(out['semantic_preds'],
                                  ref['semantic_preds'])


def test_forward_plus_proposals_on_voxels(forwards, batches):
    """Proposals are voxel sets, equal to the reference's, under level-3
    grouping of the random init's classes."""
    out, ref = forwards
    tb, _ = batches
    lv0 = tb.pyramid.levels[0]
    counts = class_active_counts(
        torch.from_numpy(out['semantic_scores']), tb.pyramid.point_valid,
        tiny_cfg(PLUS).grouping_cfg)
    assert (pyramid_levels(counts, tiny_cfg(PLUS).grouping_cfg) > 1).any()
    assert int(ref['n_proposals']) > 0
    assert int(out['n_proposals']) == int(ref['n_proposals'])
    assert _proposal_sets(out) == _proposal_sets(ref)
    for k in ('entry_pt', 'entry_seg', 'entry_valid'):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    n_vox = int(lv0.vox_valid.sum())
    assert (out['entry_pt'][out['entry_valid']] < n_vox).all()


def test_forward_plus_refinement(forwards):
    out, ref = forwards
    for k in ('cls_scores', 'iou_scores', 'mask_scores'):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_forward_plus_semantics_equal_test_forward(forwards, batches,
                                                   models):
    """The reference test's invariant: the point semantics of the ++ path
    are those of ``test_forward`` (the same heads, gathered after them)."""
    out, _ = forwards
    tb, _ = batches
    _, _, net = models
    plain = net.test_forward(tb, tiny_cfg(), Capacities(**CAPS))
    np.testing.assert_array_equal(out['semantic_preds'],
                                  plain['semantic_preds'].numpy())
    valid = tb.pyramid.point_valid.numpy()
    np.testing.assert_allclose(out['semantic_scores'][valid],
                               plain['semantic_scores'].numpy()[valid],
                               rtol=1e-4, atol=1e-4)


def test_get_instances_voxel_masks(forwards, batches):
    """``get_instances``' lvl_fusion branch: voxel masks expanded through
    p2v, as the reference's."""
    out, _ = forwards
    tb, _ = batches
    cfg = tiny_cfg(PLUS)
    n = int(tb.pyramid.point_valid.sum())
    p2v = tb.pyramid.p2v.numpy()[:n]
    n_vox = int(tb.pyramid.levels[0].vox_valid.sum())
    mine = get_instances('s', out, n_vox, cfg, v2p_map=p2v)
    theirs = jax_get_instances('s', out, n_vox, cfg, v2p_map=p2v)
    assert mine == theirs and len(mine) > 0
    assert all(d['pred_mask']['length'] == n for d in mine)


def test_get_gt_instances_matches(data):
    for sem_cls, inst_cls in ((6, 4), (20, 18)):
        got = get_gt_instances(data['semantic_labels'],
                               data['instance_labels'], sem_cls, inst_cls)
        want = jax_get_gt_instances(data['semantic_labels'],
                                    data['instance_labels'], sem_cls,
                                    inst_cls)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _instance_sets(instances):
    return sorted((d['label_id'], d['pred_mask']['counts'], d['conf'])
                  for d in instances)


@pytest.mark.parametrize('lvl_fusion', [True, False], ids=['plus', 'plain'])
def test_run_scene_matches(data, models, lvl_fusion):
    """The runner against the reference's on one scan: lvl_fusion on
    expands voxel masks through the un-permuted p2v, off un-permutes the
    point entries."""
    jnet, variables, net = models
    cfg = tiny_cfg(PLUS if lvl_fusion else TINY)
    jrunner = JaxRunner(jnet, variables, cfg, JCaps(**CAPS), 3)
    ref = jrunner.run_scene(data)
    stats = {}
    got = InferenceRunner(net, cfg, Capacities(**CAPS), 3,
                          device='cpu').run_scene(data, stats=stats)
    assert stats['caps']._asdict() == jrunner.build_batch(data)[1]._asdict()
    assert got['scan_id'] == ref['scan_id'] == 'tiny'
    # semantic_preds: torch's argmax gives int64, jnp's int32
    for k in ('semantic_preds', 'semantic_labels', 'instance_labels',
              'gt_instances'):
        assert got[k].dtype.kind == ref[k].dtype.kind == 'i', k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got['offset_preds'], ref['offset_preds'],
                               rtol=1e-4, atol=1e-4)
    mine, theirs = (_instance_sets(got['pred_instances']),
                    _instance_sets(ref['pred_instances']))
    assert len(mine) == len(theirs) > 0
    assert [m[:2] for m in mine] == [t[:2] for t in theirs]
    np.testing.assert_allclose([m[2] for m in mine], [t[2] for t in theirs],
                               rtol=1e-4, atol=1e-4)
    assert stats['n_proposals'] > 0


@pytest.mark.parametrize('native', [True, False], ids=['native', 'numpy'])
@pytest.mark.parametrize('lvl_fusion', [True, False], ids=['plus', 'plain'])
def test_runner_build_batch_matches(data, models, lvl_fusion, native):
    """The runner builds the pyramid once, at the scan's own sizes, and
    pads it to the capacities bucketed on its level counts: the caps and
    every array equal the reference runner's, which probes the counts
    with a voxelize of its own first."""
    jnet, variables, net = models
    cfg = tiny_cfg(PLUS if lvl_fusion else TINY)
    jb, jcaps = JaxRunner(jnet, variables, cfg, JCaps(**CAPS),
                          3).build_batch(data)
    tb, caps = InferenceRunner(net, cfg, Capacities(**CAPS), 3,
                               device='cpu').build_batch(data, native=native)
    assert caps._asdict() == jcaps._asdict()
    assert caps.voxels != JCaps(**CAPS).voxels   # bucketed, not the base
    n = 0
    for name, a, b in batch_arrays(tb, jb):
        b = np.asarray(b)
        a = a.numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        n += 1
    assert n == 2 + 3 * 7 - 3 + 11


def test_run_scene_panoptic_raises(data, models):
    _, _, net = models
    cfg = tiny_cfg(dict(TINY, test_cfg=dict(
        TINY['test_cfg'], eval_tasks=['semantic', 'instance', 'panoptic'])))
    runner = InferenceRunner(net, cfg, Capacities(**CAPS), 3, device='cpu')
    with pytest.raises(NotImplementedError, match='pair_keys'):
        runner.run_scene(data)


def test_plus_cfg_and_runner():
    """``entry.plus_cfg`` is the yaml's model section, as the reference
    reads it; ``build_runner`` picks ``test_forward_plus`` at the bench
    capacities and 7 levels."""
    cfg = entry.plus_cfg()
    ref = jax_load_config(entry.PLUS_YAML).model
    assert cfg.to_dict() == ref.to_dict()
    assert (cfg.channels, cfg.num_blocks, cfg.semantic_classes,
            cfg.instance_classes) == (32, 7, 20, 18)
    assert cfg.grouping_cfg.with_pyramid and cfg.test_cfg.lvl_fusion
    assert cfg.grouping_cfg.pair_keys is False
    net = SoftGroupNet(channels=8, num_blocks=3, semantic_classes=20,
                       instance_classes=18)
    runner = entry.build_runner(net, cfg, device='cpu')
    assert runner.lvl_fusion and runner.num_levels == 7
    assert runner.base_caps == entry.bench_capacities()
    assert runner.device == torch.device('cpu')
