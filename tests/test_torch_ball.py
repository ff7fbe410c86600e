"""Parity of the port's ``exact_ball_query`` grouping with the JAX
reference on the CPU: ``ball_cluster`` against the exact union-find oracle
of ``tests/test_grouping.py`` (the same partition) and against the
reference's ``ball_cluster`` (the same labels: the minimum entry index of
each component), on that file's cases; then ``forward_grouping`` with
``exact_ball_query=True``, with and without the scene pyramid, against the
reference's proposals.

Tolerances: labels, partitions and proposals exact.  Coordinates sit on a
1/64 grid where the cases allow it, so every f32 distance is exact on both
sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softgroup_tpu.data.padding import build_scene_batch as jax_batch
from softgroup_tpu.model.softgroup import Capacities as JCaps
from softgroup_tpu.model.softgroup import \
    forward_grouping as jax_forward_grouping
from softgroup_tpu_torch.data.padding import build_scene_batch
from softgroup_tpu_torch.model.softgroup import Capacities, forward_grouping
from softgroup_tpu_torch.ops.grouping import ball_cluster
from softgroup_tpu_torch.util.config import Config

from test_grouping import PAD, canon, cc_oracle, run_case
from torch_helpers import (CAPS, TINY, TINY20, batch_args, logits_clear_of,
                           tiny_cfg, tiny_data)

torch.set_num_threads(1)


def _padded(pts, batch, pad_to=PAD):
    n = len(pts)
    p = np.zeros((pad_to, 3), np.float32)
    p[:n] = pts
    b = np.zeros((pad_to,), np.int32)
    b[:n] = batch
    return p, b, np.arange(pad_to) < n


def _port(pts, batch, radius, **kw):
    p, b, valid = _padded(pts, batch)
    labels = ball_cluster(torch.from_numpy(p), torch.from_numpy(b),
                          torch.from_numpy(valid), radius, **kw).numpy()
    assert labels.dtype == np.int32
    assert (labels[len(pts):] == -1).all()
    return labels[:len(pts)]


def _uniform(rng):
    return rng.rand(80, 3).astype(np.float32) * 0.6, np.zeros(80, np.int64)


def _blobs(rng):
    centers = np.array([[0, 0, 0], [0.5, 0, 0], [0, 0.5, 0]])
    pts = np.concatenate([c + rng.randn(60, 3) * 0.01 for c in centers])
    return pts.astype(np.float32), np.zeros(180, np.int64)


def _grid_blobs(rng):
    """Dense blobs on the 1/64 grid, in two groups, with duplicate points
    (entries of one cell tie on their key: the own window decides)."""
    pts, grp = [], []
    for g in (0, 1):
        for c in ([0.25, 0.25, 0.25], [1.0, 0.25, 0.5]):
            pts.append(np.round((np.asarray(c) + rng.randn(50, 3) * 0.02)
                                * 64) / 64)
            grp.append(np.full(50, g))
    return np.concatenate(pts).astype(np.float32), np.concatenate(grp)


def _batches(rng):
    pts = np.tile(rng.rand(30, 3).astype(np.float32) * 0.1, (2, 1))
    return pts, np.repeat([0, 1], 30)


def _chain(rng):
    pts = np.zeros((150, 3), np.float32)
    pts[:, 0] = np.arange(150) * 0.039
    return pts, np.zeros(150, np.int64)


CASES = {
    'uniform': (_uniform, 0.08, dict(neighbors_per_cell=8, own_window=8)),
    'dense_blobs': (_blobs, 0.05, {}),
    'grid_blobs_groups': (_grid_blobs, 0.04, {}),
    'batch_separation': (_batches, 0.05, {}),
    'chain': (_chain, 0.04, {}),
}


@pytest.mark.parametrize('case', list(CASES))
def test_ball_cluster_matches_reference_and_oracle(case):
    """Equal labels to the reference's; the partition of the exact
    oracle (where the truncated candidate list can hold it)."""
    make, radius, kw = CASES[case]
    pts, batch = make(np.random.RandomState(0))
    got = _port(pts, batch, radius, **kw)
    want = run_case(pts, batch, radius, **kw)
    np.testing.assert_array_equal(got, want)
    assert canon(got) == canon(cc_oracle(pts, batch, radius))
    # each label is the minimum index of its component
    for comp in canon(got):
        assert all(got[i] == min(comp) for i in comp)
    if case == 'chain':
        assert len(canon(got)) == 1
    if case == 'batch_separation':
        assert not set(got[:30]) & set(got[30:])


def test_ball_cluster_all_invalid():
    labels = ball_cluster(torch.zeros((PAD, 3)),
                          torch.zeros((PAD,), dtype=torch.int32),
                          torch.zeros((PAD,), dtype=torch.bool), 0.04)
    assert (labels == -1).all()


def test_ball_cluster_raises_without_fixpoint():
    """A chain needs more rounds than one: the propagation raises at its
    bound, it does not return labels that are still changing."""
    pts, batch = _chain(None)
    with pytest.raises(RuntimeError, match='still changing'):
        _port(pts, batch, 0.04, max_rounds=1)


def _blob_cfg(with_pyramid):
    """tests/test_grouping.py::TestPerClassPyramidLevels' config."""
    return Config(dict(
        grouping_cfg=dict(
            score_thr=0.2, radius=0.3, mean_active=300,
            class_numpoint_mean=[-1.0] * 6, npoint_thr=5,
            ignore_classes=[0, 1], with_pyramid=with_pyramid,
            pyramid_thresholds=(50, 10 ** 9), exact_ball_query=True),
        test_cfg=dict(min_npoint=10)))


def _blob_inputs():
    """That test's blobs on the 1/64 grid: class 2 (2 x 20 points) and
    class 3 (2 x 40), each pair of blobs 0.5 m apart."""
    rng = np.random.RandomState(0)
    pts, cls = [], []
    for c, n_per in ((2, 20), (3, 40)):
        for bx in (0.0, 0.5):
            pts.append(np.round((np.array([bx, c * 3.0, 0.0])
                                 + rng.randn(n_per, 3) * 0.01) * 64) / 64)
            cls.append(np.full(n_per, c, np.int32))
    coords = np.concatenate(pts).astype(np.float32)
    cls = np.concatenate(cls)
    p_cap, n = 256, len(coords)
    coords_p = np.zeros((p_cap, 3), np.float32)
    coords_p[:n] = coords
    scores = np.full((p_cap, 6), -10.0, np.float32)
    scores[np.arange(n), cls] = 10.0
    return (scores, np.zeros((p_cap, 3), np.float32),
            np.zeros((p_cap,), np.int32), coords_p, np.arange(p_cap) < n)


BLOB_CAPS = dict(points=256, voxels=(256,), grouping_points=512,
                 proposals=16, proposal_entries=512, instances=8,
                 inst_voxels=(256,), grouping_cells=512)


def _same_proposals(out, ref):
    for f in ('entry_pt', 'entry_seg', 'entry_valid', 'n_proposals',
              'prop_valid'):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


@pytest.mark.parametrize('with_pyramid', [False, True],
                         ids=['flat', 'pyramid'])
def test_forward_grouping_ball_blobs(with_pyramid):
    """The reference test's per-class levels under exact_ball_query: flat,
    both classes keep their two blobs; with the pyramid, class 3 (80 active
    > 50) takes level 2 and its blobs merge."""
    cfg = _blob_cfg(with_pyramid)
    args = _blob_inputs()
    ref = jax_forward_grouping(*map(jnp.asarray, args), cfg,
                               JCaps(**BLOB_CAPS))
    out = forward_grouping(*map(torch.from_numpy, args), cfg,
                           Capacities(**BLOB_CAPS))
    _same_proposals(out, ref)
    assert int(out.n_proposals) == (3 if with_pyramid else 4)


@pytest.fixture(scope='module')
def batches():
    data = tiny_data()
    tb = build_scene_batch(*batch_args(data), Capacities(**CAPS),
                           num_levels=3, device='cpu')
    jb = jax_batch(*batch_args(data), JCaps(**CAPS), num_levels=3)
    return tb, jb


@pytest.mark.parametrize('cfg_dict,with_pyramid', [
    (TINY, False), (TINY, True), (TINY20, False)],
    ids=['6cls', '6cls-pyramid', '20cls'])
def test_forward_grouping_ball_scene(batches, cfg_dict, with_pyramid):
    """Two tiny scenes, seeded scores clear of score_thr and offsets on the
    1/64 grid: the same proposals as the reference's, on both branches of
    the entry compaction (20 classes: the per-point top-k) and at pyramid
    levels above 1."""
    tb, jb = batches
    cfg = tiny_cfg(dict(cfg_dict, grouping_cfg=dict(
        cfg_dict['grouping_cfg'], exact_ball_query=True,
        with_pyramid=with_pyramid, pyramid_thresholds=(400, 1500))))
    n_cls = cfg.semantic_classes
    p = CAPS['points']
    rng = np.random.RandomState(n_cls + with_pyramid)
    sem = logits_clear_of(rng, p, n_cls, cfg.grouping_cfg.score_thr)
    sem[:, 2:4] += 1.5
    off = (rng.randint(-3, 4, (p, 3)) / 64).astype(np.float32)
    ref = jax_forward_grouping(
        jnp.asarray(sem), jnp.asarray(off), jb.batch_idxs, jb.coords_float,
        jb.pyramid.point_valid, cfg, JCaps(**CAPS))
    out = forward_grouping(torch.from_numpy(sem), torch.from_numpy(off),
                           tb.batch_idxs, tb.coords_float,
                           tb.pyramid.point_valid, cfg, Capacities(**CAPS))
    assert int(ref.n_proposals) > 2
    _same_proposals(out, ref)
