"""Parity of the port's train CLI on a SemanticKITTI-style pair-key model
section with the JAX reference on the CPU: two steps of the CLI's train
state (``train_cli.build_train_state``: Adam at the cosine schedule, a
``clip_grad_norm`` that binds) against the reference's
``make_train_step(..., mesh=None)`` with ``tools/train.py``'s optax chain;
then ``train_cli.main`` end to end on a SemanticKITTI-layout folder
(sequences 00-10 of tiny scans written to a temp dir) with the KITTI
yaml's model section at a narrow width.

The section is the KITTI yaml's shape at the tiny config's width: one
input channel (the first colour channel standing in for remission),
``with_coords`` off, ``pair_keys`` at its default (int64 cell keys), a
clip of 1.0 (the yaml's 35 does not bind at this width).  The two steps
run on ``tests/torch_helpers.py``'s tiny scenes (coordinates on a 1/64
grid, the offset head zeroed: exact grouping).  Tolerances (those of
``tests/test_torch_train_cli.py``): losses within 1e-4, the first step's
running statistics within 1e-5, each step's update on the port's own
gradients within 1e-6, the recorded pre-clip norm within 1e-5 of optax's
``global_norm``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from softgroup_tpu.data.padding import build_scene_batch as jax_batch
from softgroup_tpu.model.softgroup import Capacities as JCaps
from softgroup_tpu.model.softgroup import SoftGroupNet as JNet
from softgroup_tpu.parallel.mesh import TrainState as JTrainState
from softgroup_tpu.parallel.mesh import make_train_step as jax_train_step
from softgroup_tpu.util import optim as jopt
from softgroup_tpu_torch import entry
from softgroup_tpu_torch.data.padding import build_scene_batch
from softgroup_tpu_torch.model.softgroup import Capacities, SoftGroupNet
from softgroup_tpu_torch.ops import grouping
from softgroup_tpu_torch.tools_impl import train_cli
from softgroup_tpu_torch.util.checkpoint import reference_state_dict
from softgroup_tpu_torch.util.config import Config, load_config
from softgroup_tpu_torch.util.convert import from_jax_variables

from test_torch_kitti import _write_kitti
from test_torch_train_cli import _flax_tree, _leaves
from torch_helpers import CAPS, TINY, batch_args, tiny_data

torch.set_num_threads(1)

CLIP = 1.0
KITTI_STYLE = dict(
    TINY, channels=4, with_coords=False, in_channels=1, fixed_modules=[],
    grouping_cfg={k: v for k, v in TINY['grouping_cfg'].items()
                  if k != 'pair_keys'})
TWO_STEP_CFG = dict(optimizer=dict(type='Adam', lr=0.004), epochs=2,
                    step_epoch=1, clip_grad_norm=CLIP, model=KITTI_STYLE)


def _remission(data):
    """The scene with its first colour channel as the one input feature."""
    return dict(data, feats=np.ascontiguousarray(data['feats'][:, :1]))


@pytest.fixture(scope='module')
def two_steps():
    """Two steps on both sides from one set of weights (a seeded port
    init, its offset head zeroed and its running statistics moved off
    their init values), the reference key's quantization draws fed to the
    port as ``rand``: the port's state, its logs, parameters, unclipped
    gradients and recorded norms at each step, the cell-key dtypes of its
    grouping, the reference's state and logs, the initial variables and
    the optax chain."""
    cfg = Config(TWO_STEP_CFG)
    caps, jcaps = Capacities(**CAPS), JCaps(**CAPS)
    datas = [_remission(tiny_data(seed)) for seed in (1, 2)]
    tbs = [build_scene_batch(*batch_args(d), caps, num_levels=3,
                             with_coords=False, device='cpu') for d in datas]
    jbs = [jax_batch(*batch_args(d), jcaps, num_levels=3, with_coords=False)
           for d in datas]
    assert tbs[0].vox_in.shape[1] == 1
    net = SoftGroupNet(channels=4, num_blocks=3, semantic_classes=6,
                       instance_classes=4, bf16=False, in_channels=1,
                       generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        net.offset_linear.final_kernel.zero_()
        net.offset_linear.final_bias.zero_()
        for name, buf in net.named_buffers():
            buf.add_(torch.rand(buf.shape,
                                generator=torch.Generator().manual_seed(
                                    len(name))) * 0.1)
    variables = _flax_tree(net)
    net = entry.build_net(cfg.model, device='cpu', bf16=False)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    jnet = JNet(channels=4, num_blocks=3, semantic_classes=6,
                instance_classes=4, bf16=False)

    state, _ = train_cli.build_train_state(net, cfg, caps, 2)
    jsched = jopt.cosine_after_step_schedule(0.004, 1, 2, 2)
    tx = optax.chain(
        jopt.clip_by_global_norm(CLIP),
        jopt.masked_optimizer(jopt.build_optimizer(
            variables['params'], cfg.optimizer, jsched),
            variables['params'], []))
    jstate = JTrainState(params=variables['params'],
                         batch_stats=variables['batch_stats'],
                         opt_state=tx.init(variables['params']),
                         step=jnp.zeros((), jnp.int32))
    jstep = jax_train_step(jnet, cfg.model, jcaps, tx, None)
    rng = jax.random.PRNGKey(42)
    out = dict(logs=[], jlogs=[], params=[], grads=[], norms=[], keys=[],
               stats=[], jstats=[])
    clip = torch.nn.utils.clip_grad_norm_
    join = grouping.cell_neighbor_join

    def keep_grads(ps, max_norm):
        ps = list(ps)
        out['grads'].append({k: p.grad.numpy().copy()
                             for k, p in state.net.named_parameters()})
        return clip(ps, max_norm)

    def record(*a):
        out['keys'].append(a[0].dtype)
        return join(*a)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.utils, 'clip_grad_norm_', keep_grads)
        mp.setattr(grouping, 'cell_neighbor_join', record)
        for tb, jb in zip(tbs, jbs):
            rng, sub = jax.random.split(rng)
            rand = np.stack([np.asarray(jax.random.uniform(sub, (3,))),
                             np.asarray(jax.random.uniform(
                                 jax.random.fold_in(sub, 1), (3,)))])
            out['logs'].append({k: float(v) for k, v in state.step(
                tb, rand=torch.from_numpy(rand)).items()})
            out['norms'].append(float(state.step.grad_norm))
            out['params'].append({k: p.detach().numpy().copy()
                                  for k, p in state.net.named_parameters()})
            out['stats'].append({k: b.numpy().copy() for k, b in
                                 state.net.named_buffers()})
            jstate, jl = jstep(jstate, jb, sub)
            out['jlogs'].append({k: float(v) for k, v in jl.items()})
            out['jstats'].append(dict(_leaves(jstate.batch_stats)))
    return dict(out, state=state, jstate=jstate, variables=variables, tx=tx)


def test_two_kitti_cli_steps_match(two_steps):
    """Both steps' losses within 1e-4, the first step's running statistics
    within 1e-5, each step's parameters equal to the optax chain (clip,
    Adam at the schedule) applied to the port's own gradients within 1e-6;
    the clip bound both steps, and the norm the step records is optax's
    ``global_norm`` of those gradients; the grouping joined int64 keys.

    As in ``test_two_cli_steps_match``, parameters are not held entry by
    entry to the reference's (a bias ahead of a batch norm has a zero
    gradient, rounding noise that Adam scales to +-lr on each side), so
    the second step's running statistics, which the first step's update
    shifts by 0.1 x that noise, are not either."""
    t = two_steps
    assert t['keys'] == [torch.int64] * 2
    for got, want in zip(t['logs'], t['jlogs']):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    assert t['jlogs'][0]['num_pos'] > 0 and t['jlogs'][1]['num_pos'] > 0
    assert t['state'].step.updates == int(t['jstate'].step) == 2
    assert set(t['stats'][0]) == set(t['jstats'][0])
    for k, b in t['stats'][0].items():
        np.testing.assert_allclose(b, t['jstats'][0][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)

    tx = t['tx']

    @jax.jit
    def update(g, opt_state, p):
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state
    jp = jax.tree.map(jnp.asarray, t['variables']['params'])
    opt_state = tx.init(jp)
    for params, grads, norm in zip(t['params'], t['grads'], t['norms']):
        g = {k: jnp.asarray(v) for k, v in grads.items()}
        want = float(optax.global_norm(g))
        np.testing.assert_allclose(norm, want, rtol=1e-5)
        assert norm > CLIP   # the clip bound
        tree = jax.tree_util.tree_map_with_path(
            lambda path, _: g['.'.join(p.key for p in path)], jp)
        jp, opt_state = update(tree, opt_state, jp)
        for k, w in _leaves(jp):
            np.testing.assert_allclose(params[k], w, rtol=1e-6, atol=1e-6,
                                       err_msg=k)


# the sequences of the yaml's train split, and its validation sequence
TRAIN_SEQS = (0, 1, 2, 3, 4, 5, 6, 7, 9, 10)
VAL_SEQ = 8


MAIN_CLIP = 0.1


def test_train_cli_main_kitti(tmp_path):
    """``main(--device cpu)`` for one epoch on the KITTI yaml's whole config
    at channels 4, 3 levels, batch 5 (the yaml's train split: one scan in
    each of its ten sequences, elastic distortion at 1/5 scale, the crop),
    from a reference ``.pth`` of a seeded net whose semantic head's bias is
    lifted on two thing classes (else grouping has nothing to group), with
    the clip at 0.1: each step's losses finite, its pre-clip norm recorded
    and above the clip, proposals on a step; the checkpoint written; the
    validation on sequence 08 returns PQ."""
    root = tmp_path / 'kitti'
    for i, seq in enumerate(TRAIN_SEQS):
        _write_kitti(root, n_scans=1, seed=10 + i, seq=seq)
    _write_kitti(root, n_scans=2, seed=30, seq=VAL_SEQ)
    cfg = load_config(entry.KITTI_YAML)
    assert cfg.clip_grad_norm == 35 and 'pair_keys' not in \
        cfg.model.grouping_cfg
    cfg.model.channels, cfg.model.num_blocks = 4, 3
    cfg.clip_grad_norm = MAIN_CLIP
    cfg.epochs = 1
    cfg.work_dir = str(tmp_path / 'work')
    cfg.pretrain = str(tmp_path / 'lifted.pth')
    net = train_cli.build_net(cfg, 'cpu')
    sd = net.state_dict()
    sd['semantic_linear.final_bias'][11:13] = 2.5
    torch.save({'net': reference_state_dict(sd)}, cfg.pretrain)
    for split in ('train', 'test'):
        cfg.data[split].data_root = str(root)
        cfg.data[split].voxel_cfg.max_npoint = 2500
        cfg.data[split].voxel_cfg.min_npoint = 300
    cfg.data.train.seed = 3
    cfg.dataloader.train.batch_size = 5
    cfg.dataloader.train.num_workers = 0
    cfg.dataloader.test.num_workers = 0
    cfg.tpu.num_levels = 3
    cfg.tpu.caps = dict(points=16384, voxels=[16384, 16384, 8192],
                        grouping_points=32768, proposals=32,
                        proposal_entries=16384, instances=64,
                        inst_voxels=[4096, 1024], grouping_cells=16384)
    path = str(tmp_path / 'softgroup_kitti.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg.to_dict(), f)
    stats = {}
    train_cli.main([path, '--device', 'cpu'], stats=stats)
    assert stats['steps_per_epoch'] == 2 and len(stats['steps']) == 2
    for s in stats['steps']:
        assert all(np.isfinite(v) for v in s['logs'].values()), s['logs']
        assert s['grad_norm'] > MAIN_CLIP, s['grad_norm']
    assert any(s['logs']['num_pos'] + s['logs']['num_neg'] > 0
               for s in stats['steps'])
    assert sorted(os.listdir(tmp_path / 'work' / 'ckpt')) == [
        'epoch_1', 'latest']
    (epoch,) = stats['epochs']
    assert sorted(epoch['val']) == ['PQ'] and np.isfinite(epoch['val']['PQ'])
