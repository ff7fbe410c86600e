"""Parity of the port's training entry point with the JAX reference on the
CPU: the epoch sampler, the training loader, the optimizer with its
schedule and clip, two train-CLI steps against the reference's
``make_train_step``, the checkpoint manager, and ``train_cli.main`` end to
end on the tiny config of ``tests/test_cli.py`` (channels 4, 3 levels,
batch 2, 1200-point scans) with ``--resume`` and validation.

Tolerances: sampler indices, loader batches, checkpoint state and the
metrics of a checkpoint exact; optimizer updates on equal gradients within
1e-6 relative (atol 1e-8: a few f32 roundings of a 0.004 update); the two
CLI steps as ``tests/test_torch_train.py``'s slice: losses within 1e-4,
parameters within 1e-6 of the reference's (Adam normalises each update, so
gradients equal to 1e-4 give updates equal to ~1e-7 of the learning rate).
"""

import copy
import json
import os
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from softgroup_tpu.data import build_dataloader as jax_build_dataloader
from softgroup_tpu.data import build_dataset as jax_build_dataset
from softgroup_tpu.data.loader import EpochSampler as JEpochSampler
from softgroup_tpu.data.padding import build_scene_batch as jax_batch
from softgroup_tpu.model.softgroup import Capacities as JCaps
from softgroup_tpu.model.softgroup import SoftGroupNet as JNet
from softgroup_tpu.parallel.mesh import TrainState as JTrainState
from softgroup_tpu.parallel.mesh import make_train_step as jax_train_step
from softgroup_tpu.tools_impl.test_runner import summarize as jax_summarize
from softgroup_tpu.util import checkpoint as jckpt
from softgroup_tpu.util import optim as jopt
from softgroup_tpu_torch.data import (EpochSampler, build_dataloader,
                                      build_dataset)
from softgroup_tpu_torch.data.padding import build_scene_batch
from softgroup_tpu_torch.model.softgroup import Capacities, SoftGroupNet
from softgroup_tpu_torch.tools_impl import test_cli, train_cli
from softgroup_tpu_torch.tools_impl.test_runner import run_split
from softgroup_tpu_torch.train import TrainState, make_train_step
from softgroup_tpu_torch.util import checkpoint
from softgroup_tpu_torch.util.config import Config, load_config
from softgroup_tpu_torch.util.convert import from_jax_variables
from softgroup_tpu_torch.util.optim import (build_optimizer,
                                            cosine_after_step_schedule,
                                            freeze)

from test_cli import _make_config, _make_dataset
from torch_helpers import CAPS, TINY, batch_args, tiny_data

torch.set_num_threads(1)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _leaves(v, prefix + (k,))
        else:
            yield '.'.join(prefix + (k,)), np.asarray(v)


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    """The tiny config of tests/test_cli.py over four 1200-point train
    scans (repeat 5: ten batches of two an epoch) and one val scan, with
    a seeded dataset and a ``pretrain`` path that does not exist (the
    KITTI and STPLS3D instance yamls name ``work_dirs/<backbone>/latest``,
    which the CLI never writes); returns (root, config path)."""
    root = tmp_path_factory.mktemp('train_cli')
    _make_dataset(str(root / 'data'), n_scans=4)
    path = _make_config(root, str(root / 'data'))
    cfg = load_config(path)
    cfg.data.train.repeat = 5
    cfg.data.train.seed = 3
    cfg.pretrain = str(root / 'work_dirs' / 'backbone' / 'latest')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg.to_dict(), f)
    return root, path


# ---------------------------------------------------------------------------
# the sampler and the training loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('world,rank,drop_last', [
    (1, 0, True), (1, 0, False), (2, 0, True), (2, 1, True), (2, 0, False),
    (2, 1, False)])
def test_epoch_sampler_matches(world, rank, drop_last):
    """Epochs 0-2 of an odd-sized set: the same shuffled, rank-strided
    indices (padded or truncated to the world)."""
    for epoch in range(3):
        got = EpochSampler(11, rank, world, True, drop_last).indices(epoch)
        want = JEpochSampler(11, rank, world, True, drop_last).indices(epoch)
        np.testing.assert_array_equal(got, want)


def _assert_same(a, b, what=''):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _assert_same(a[k], b[k], f'{what}.{k}')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def test_train_loader_matches(tiny):
    """``num_workers=0``, the same dataset seed, two epochs: the reference
    loader's batches, array for array (the augmentations drawn in the
    sampler's order from one rng), and its length."""
    cfg = load_config(tiny[1])
    mine = build_dataloader(build_dataset(cfg.data.train), batch_size=2,
                            training=True)
    ref = jax_build_dataloader(jax_build_dataset(cfg.data.train),
                               batch_size=2, training=True)
    assert len(mine) == len(ref) == 10
    for epoch in (1, 2):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(mine), list(ref)
        assert len(got) == len(want) == 10
        for a, b in zip(got, want):
            _assert_same(a, b, f'epoch {epoch}')


def _first_items(batches):
    return [b['coords'][b['coords'][:, 0] == 0] for b in batches]


def test_worker_draws(tiny):
    """One scan repeated four times, a batch each.  The reference's worker
    pool unpickles the parent's never-advanced rng into every batch: all
    four batches repeat one augmentation.  The port's two workers reseed
    from (seed, epoch, worker id): no two batches repeat, and worker 0's
    first batch is the dataset's item drawn from ``SeedSequence([seed,
    epoch, 0])``, which differs between epochs."""
    cfg = load_config(tiny[1])
    train = Config(cfg.data.train, prefix='val', repeat=4)
    ref = jax_build_dataloader(jax_build_dataset(train), batch_size=1,
                               num_workers=1, training=True)
    batches = []
    reader = threading.Thread(target=lambda: batches.extend(ref),
                              daemon=True)
    reader.start()
    reader.join(timeout=120)
    assert not reader.is_alive(), 'the reference loader did not finish'
    want = _first_items(batches)
    assert len(want) == 4
    assert all(np.array_equal(want[0], w) for w in want[1:])

    ds = build_dataset(train)
    mine = build_dataloader(ds, batch_size=1, num_workers=2, training=True)
    mine.set_epoch(1)
    got = list(mine)
    items = _first_items(got)
    assert len(items) == 4
    assert not any(np.array_equal(items[i], items[j])
                   for i in range(4) for j in range(i + 1, 4))
    firsts = []
    for epoch in (1, 2):
        ds.rng = np.random.RandomState(
            np.random.SeedSequence([3, epoch, 0]).generate_state(4))
        firsts.append(ds.collate_fn([ds[EpochSampler(4).indices(epoch)[0]]]))
    _assert_same(got[0], firsts[0])
    assert not np.array_equal(firsts[0]['coords'], firsts[1]['coords'])


# ---------------------------------------------------------------------------
# the optimizer: build_optimizer + schedule + clip against the optax chain
# ---------------------------------------------------------------------------

class _Grads(torch.nn.Module):
    """A net whose update k's gradients are ``grads[k]``: its loss is
    sum(p * g) over the parameters (what ``TrainStep`` calls)."""

    def __init__(self, params: dict, grads: list):
        super().__init__()
        for top, leaves in params.items():
            mod = torch.nn.Module()
            for k, v in leaves.items():
                setattr(mod, k, torch.nn.Parameter(torch.tensor(v)))
            setattr(self, top, mod)
        self.grads = grads

    def loss_forward(self, k, cfg, caps, generator=None, rand=None):
        loss = sum((p * torch.tensor(self.grads[k][n])).sum()
                   for n, p in self.named_parameters())
        return loss, {'loss': loss}


@pytest.mark.parametrize('opt,clip', [('Adam', 2.0), ('AdamW', None),
                                      ('SGD', None)])
def test_optimizer_matches_optax(opt, clip):
    """Six updates on seeded gradients with a frozen module, two updates
    an epoch and the cosine starting after epoch 1 of 3: the parameters
    after each update against ``tools/train.py``'s optax chain (clip by
    global norm, then the masked optimizer), and each update's learning
    rate against the reference's schedule.  The Adam case's clip binds
    (gradient norms ~7 against 2)."""
    rng = np.random.RandomState(0)
    shapes = {'a': {'w': (5, 4), 'b': (4,)}, 'c': {'w': (7, 3)},
              'frozen': {'w': (6,)}}
    params = {t: {k: rng.randn(*s).astype(np.float32) for k, s in v.items()}
              for t, v in shapes.items()}
    grads = [{f'{t}.{k}': rng.randn(*s).astype(np.float32)
              for t, v in shapes.items() for k, s in v.items()}
             for _ in range(6)]
    cfg = Config(type=opt, lr=0.004)
    fixed = ['frozen']
    sched = cosine_after_step_schedule(0.004, 1, 3, 2)
    jsched = jopt.cosine_after_step_schedule(0.004, 1, 3, 2)

    net = _Grads(params, grads)
    optimizer = build_optimizer(freeze(net, fixed), cfg, sched)
    step = make_train_step(net, None, None, optimizer, fixed, sched, clip)

    tx = optax.chain(jopt.clip_by_global_norm(clip), jopt.masked_optimizer(
        jopt.build_optimizer(params, cfg, jsched), params, fixed))
    @jax.jit
    def update(g, state, p):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for k in range(6):
        step(k)
        assert step.updates == k + 1
        np.testing.assert_allclose(optimizer.param_groups[0]['lr'],
                                   float(jsched(k)), rtol=1e-6)
        # the reference zero-fills a frozen module's gradients
        g = {t: {n: (np.zeros_like(a) if t in fixed
                     else grads[k][f'{t}.{n}']) for n, a in v.items()}
             for t, v in params.items()}
        jp, state = update(jax.tree.map(jnp.asarray, g), state, jp)
        want = dict(_leaves(jp))
        for n, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n],
                                       rtol=1e-6, atol=1e-8,
                                       err_msg=f'{opt} update {k} {n}')
    np.testing.assert_array_equal(net.frozen.w.detach().numpy(),
                                  params['frozen']['w'])
    assert float(jsched(5)) < 0.004    # the cosine was crossed


# ---------------------------------------------------------------------------
# two CLI steps against the reference's make_train_step
# ---------------------------------------------------------------------------

TWO_STEP_CFG = dict(optimizer=dict(type='Adam', lr=0.004), epochs=2,
                    step_epoch=1, clip_grad_norm=1.0,
                    model=dict(TINY, channels=4, fixed_modules=[]))


def _flax_tree(net: SoftGroupNet) -> dict:
    """The port's parameters and batch-norm buffers as a flax variable
    tree (numpy leaves): the inverse of ``from_jax_variables``."""
    tree = {'params': {}, 'batch_stats': {}}
    items = [('params', k, v) for k, v in net.named_parameters()]
    items += [('batch_stats', k, v) for k, v in net.named_buffers()]
    for coll, key, val in items:
        node = tree[coll]
        *path, leaf = key.split('.')
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val.detach().numpy().copy()
    return tree


@pytest.fixture(scope='module')
def two_steps():
    """Two steps of the train CLI's state (``build_train_state``: Adam,
    the cosine schedule, a binding clip) and of the reference's
    ``make_train_step(..., mesh=None)`` with ``tools/train.py``'s optax
    chain, from one set of weights carried across by ``from_jax_variables``
    (a seeded port init, its offset head zeroed and its running statistics
    moved off their init values), on the same two batches (tiny scenes on
    the 1/64 grid: exact grouping), the reference key's quantization draws
    fed to the port as ``rand``.  Returns the port's state, its logs, its
    parameters and its unclipped gradients at each step, the reference's
    state, its logs and the initial variables."""
    cfg = Config(TWO_STEP_CFG)
    caps, jcaps = Capacities(**CAPS), JCaps(**CAPS)
    datas = [tiny_data(seed) for seed in (1, 2)]
    tbs = [build_scene_batch(*batch_args(d), caps, num_levels=3,
                             device='cpu') for d in datas]
    jbs = [jax_batch(*batch_args(d), jcaps, num_levels=3) for d in datas]
    net = SoftGroupNet(channels=4, num_blocks=3, semantic_classes=6,
                       instance_classes=4, bf16=False,
                       generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        net.offset_linear.final_kernel.zero_()
        net.offset_linear.final_bias.zero_()
        for name, buf in net.named_buffers():
            buf.add_(torch.rand(buf.shape,
                                generator=torch.Generator().manual_seed(
                                    len(name))) * 0.1)
    variables = _flax_tree(net)
    net = SoftGroupNet(channels=4, num_blocks=3, semantic_classes=6,
                       instance_classes=4, bf16=False)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    jnet = JNet(channels=4, num_blocks=3, semantic_classes=6,
                instance_classes=4, bf16=False)

    state, _ = train_cli.build_train_state(net, cfg, caps, 2)
    jsched = jopt.cosine_after_step_schedule(0.004, 1, 2, 2)
    tx = optax.chain(
        jopt.clip_by_global_norm(cfg.clip_grad_norm),
        jopt.masked_optimizer(jopt.build_optimizer(
            variables['params'], cfg.optimizer, jsched),
            variables['params'], []))
    jstate = JTrainState(params=variables['params'],
                         batch_stats=variables['batch_stats'],
                         opt_state=tx.init(variables['params']),
                         step=jnp.zeros((), jnp.int32))
    jstep = jax_train_step(jnet, cfg.model, jcaps, tx, None)
    rng = jax.random.PRNGKey(42)
    logs, jlogs, params, grads = [], [], [], []
    clip = torch.nn.utils.clip_grad_norm_

    def keep_grads(ps, max_norm):
        ps = list(ps)
        grads.append({k: p.grad.numpy().copy()
                      for k, p in state.net.named_parameters()})
        return clip(ps, max_norm)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.utils, 'clip_grad_norm_', keep_grads)
        for tb, jb in zip(tbs, jbs):
            rng, sub = jax.random.split(rng)
            rand = np.stack([np.asarray(jax.random.uniform(sub, (3,))),
                             np.asarray(jax.random.uniform(
                                 jax.random.fold_in(sub, 1), (3,)))])
            logs.append({k: float(v) for k, v in state.step(
                tb, rand=torch.from_numpy(rand)).items()})
            params.append({k: p.detach().numpy().copy()
                           for k, p in state.net.named_parameters()})
            jstate, jl = jstep(jstate, jb, sub)
            jlogs.append({k: float(v) for k, v in jl.items()})
    return dict(state=state, logs=logs, params=params, grads=grads,
                jstate=jstate, jlogs=jlogs, variables=variables, tx=tx)


def test_two_cli_steps_match(two_steps):
    """Both steps' losses within the slice's 1e-4 (the second step's on
    the weights the first updated) and the running statistics within
    1e-5; the update rule at ``test_slice_adam_step``'s 1e-6: each step's
    parameters equal ``tools/train.py``'s optax chain (clip, Adam at the
    schedule) applied to the port's own gradients.  The parameters are not
    held entry by entry to the reference's: a bias ahead of a batch norm
    has a zero gradient, rounding noise that Adam scales to +-lr on each
    side."""
    t = two_steps
    for got, want in zip(t['logs'], t['jlogs']):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    assert t['jlogs'][0]['num_pos'] > 0 and t['jlogs'][1]['num_pos'] > 0
    assert t['state'].step.updates == int(t['jstate'].step) == 2
    stats = dict(_leaves(t['jstate'].batch_stats))
    for k, b in t['state'].net.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)

    tx = t['tx']

    @jax.jit
    def update(g, opt_state, p):
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state
    jp = jax.tree.map(jnp.asarray, t['variables']['params'])
    opt_state = tx.init(jp)
    norms = []
    for params, grads in zip(t['params'], t['grads']):
        g = {k: jnp.asarray(v) for k, v in grads.items()}
        norms.append(float(optax.global_norm(g)))
        tree = jax.tree_util.tree_map_with_path(
            lambda path, _: g['.'.join(p.key for p in path)], jp)
        jp, opt_state = update(tree, opt_state, jp)
        for k, want in _leaves(jp):
            np.testing.assert_allclose(params[k], want, rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    assert min(norms) > 1.0   # the clip bound both steps


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_retention_and_restore(tmp_path):
    """Ten epochs at save_freq 3: the reference's ``should_keep`` entries
    stay (with the latest); a load restores the net, the optimizer and the
    update count exactly and gives the next epoch."""
    net = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(net.parameters(), lr=0.01)
    step = make_train_step(net, None, None, opt)
    state = TrainState(net, opt, step)
    mgr = checkpoint.CheckpointManager(str(tmp_path), save_freq=3)
    assert mgr.load(state) == 1 and step.updates == 0
    saved = {}
    for epoch in range(1, 11):
        net(torch.randn(5, 4)).square().sum().backward()
        opt.step()
        step.updates += 2
        mgr.save(state, epoch)
        saved[epoch] = (
            {k: v.clone() for k, v in net.state_dict().items()},
            copy.deepcopy(opt.state_dict()), step.updates)
    kept = sorted(int(f.split('_')[1]) for f in os.listdir(mgr.dir)
                  if f.startswith('epoch_'))
    assert kept == [e for e in range(1, 10)
                    if jckpt.should_keep(e, 3)] + [10]
    assert kept == [1, 2, 3, 4, 6, 8, 9, 10]
    assert mgr.latest_epoch() == 10

    fresh = torch.nn.Linear(4, 3)
    fopt = torch.optim.Adam(fresh.parameters(), lr=0.01)
    fstate = TrainState(fresh, fopt, make_train_step(fresh, None, None,
                                                     fopt))
    for epoch, want_next in ((None, 11), (8, 9)):
        assert mgr.load(fstate, epoch) == want_next
        sd, osd, updates = saved[epoch or 10]
        for k, v in fresh.state_dict().items():
            assert torch.equal(v, sd[k]), k
        _assert_state_equal(fopt.state_dict(), osd)
        assert fstate.step.updates == updates


def _assert_state_equal(a, b, what='optimizer'):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b), what
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _assert_state_equal(a[k], b[k], f'{what}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_state_equal(x, y, f'{what}[{i}]')
    else:
        assert a == b, what


# ---------------------------------------------------------------------------
# the CLI end to end
# ---------------------------------------------------------------------------

EPOCH_LINE = re.compile(
    r'Epoch \[(\d+)/(\d+)\]\[10/10\] lr \S+ eta \d+\.\dh mem 0MB '
    r'iter \d+\.\d\ds \((\w+: -?\d+\.\d{4}(, )?)+\)$')


def test_train_cli_main(tiny, two_steps, monkeypatch):
    """``main(--device cpu)`` for two epochs, then ``--resume --epochs 3``:
    the reference's log lines and scalar keys, the checkpoints kept, the
    resumed state equal to the saved one, the validation at epochs 1 and
    2 (powers of two) and not at 3, and the test CLI on the epoch-2
    checkpoint giving the same metrics as that validation."""
    root, path = tiny
    work = root / 'work'
    first = {}
    train_cli.main([path, '--device', 'cpu', '--epochs', '2'], stats=first)
    assert first['steps_per_epoch'] == 10 and first['start_epoch'] == 1
    sched = cosine_after_step_schedule(0.004, 1, 2, 10)
    assert [s['lr'] for s in first['steps']] == [sched(k) for k in range(20)]
    assert [s['update'] for s in first['steps']] == list(range(20))

    restored = {}
    load = checkpoint.CheckpointManager.load

    def keep(self, state, epoch=None):
        nxt = load(self, state, epoch)
        restored.update(net={k: v.clone() for k, v in
                             state.net.state_dict().items()},
                        opt=copy.deepcopy(state.optimizer.state_dict()),
                        updates=state.step.updates)
        return nxt
    monkeypatch.setattr(checkpoint.CheckpointManager, 'load', keep)
    second = {}
    train_cli.main([path, '--device', 'cpu', '--epochs', '3', '--resume'],
                   stats=second)
    assert second['start_epoch'] == 3 and second['load_ms'] > 0
    assert [s['update'] for s in second['steps']] == list(range(20, 30))
    sched3 = cosine_after_step_schedule(0.004, 1, 3, 10)
    assert [s['lr'] for s in second['steps']] == [sched3(k)
                                                   for k in range(20, 30)]
    saved = torch.load(work / 'ckpt' / 'epoch_2', weights_only=True)
    assert saved['epoch'] == 2 and saved['updates'] == restored['updates'] \
        == 20
    for k, v in saved['net'].items():
        assert torch.equal(v, restored['net'][k]), k
    _assert_state_equal(restored['opt'], saved['optimizer'])

    log = (work / 'train.log').read_text()
    lines = [ln.split(' - INFO - ', 1)[1] for ln in log.splitlines()
             if ' - INFO - ' in ln]
    epochs = [EPOCH_LINE.match(ln) for ln in lines
              if ln.startswith('Epoch [')]
    assert [(m.group(1), m.group(2)) for m in epochs] == [
        ('1', '2'), ('2', '2'), ('3', '3')], lines
    assert 'resumed at epoch 3' in lines and lines.count('training done') \
        == 2
    skipped = [ln for ln in lines if ln.startswith('pretrain ')]
    assert skipped == [f'pretrain {cfg_pretrain(path)} not found: not '
                       f'imported'] * 2

    kept = sorted(os.listdir(work / 'ckpt'))
    assert kept == ['epoch_1', 'epoch_2', 'epoch_3', 'latest']
    assert (work / 'ckpt' / 'latest').read_text() == 'epoch_3'

    # the scalars tools/train.py writes: train/<the step's log keys>,
    # train/lr every epoch, val/<each numeric metric> when validating
    with open(work / 'scalars.jsonl') as f:
        recs = [json.loads(line) for line in f]
    assert all(set(r) == {'t', 'step', 'key', 'value'} for r in recs)
    cfg = load_config(path)
    results, dataset = run_split(train_cli.build_net(cfg, 'cpu'), cfg,
                                 train_cli.caps_from_cfg(cfg), 3,
                                 device='cpu')
    val_keys = {f'val/{k}' for k, v in jax_summarize(
        results, cfg, dataset).items() if isinstance(v, (int, float))}
    train_keys = {f'train/{k}' for k in two_steps['jlogs'][0]} | {
        'train/lr'}
    for epoch in (1, 2, 3):
        keys = {r['key'] for r in recs if r['step'] == epoch}
        assert keys == train_keys | (val_keys if epoch < 3 else set()), \
            epoch
    val2 = {r['key'][4:]: r['value'] for r in recs
            if r['step'] == 2 and r['key'].startswith('val/')}
    assert val2 == {k: float(v) for k, v in next(
        e['val'] for e in first['epochs'] if e['epoch'] == 2).items()}

    metrics = test_cli.main([path, '--checkpoint',
                             str(work / 'ckpt' / 'epoch_2'), '--device',
                             'cpu'])
    assert {k: float(v) for k, v in metrics.items()} == val2


def cfg_pretrain(path):
    return load_config(path).pretrain
