"""Parity of the port's data parallelism (``parallel/ddp.py``, the train
step with a process group, the loader's batch grouping and the train
CLI's ``--num-devices``) with the reference's mesh step
(``softgroup_tpu/parallel/mesh.py``) on the CPU.

The port's ranks are two spawned processes over gloo; the reference runs
``make_train_step(mesh=make_mesh(2))`` on ``stack_batches([b0, b1])`` over
two of the suite's virtual CPU devices, its step key folded with the
device index: rank ``r`` is fed the draws of ``fold_in(key, r)``.  The
tiny net of ``tests/test_torch_train_cli.py``'s two CLI steps (channels 4,
3 levels, Adam with a binding clip, coordinates on a 1/64 grid).

Tolerances, those of ``test_two_cli_steps_match``: the averaged logs
within 1e-4 of the reference's and the batch-norm buffers within 1e-5;
each step's parameters within 1e-6 of ``tools/train.py``'s optax chain
applied to the port's averaged gradients.  Between the ranks, parameters,
buffers and logs are equal bit for bit; the averaged gradients equal the
mean of the two ranks' local gradients (one backward each on the same
batch and draw, no group) within 1e-6 x max|g|, the bound of the card's
check.

The JAX side imports lazily: the spawned ranks import this module.
"""

import copy
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from softgroup_tpu_torch.data.padding import build_scene_batch
from softgroup_tpu_torch.model.blocks import MaskedBatchNorm
from softgroup_tpu_torch.model.softgroup import Capacities, SoftGroupNet
from softgroup_tpu_torch.parallel import ddp
from softgroup_tpu_torch.tools_impl import train_cli
from softgroup_tpu_torch.train import set_train_modes
from softgroup_tpu_torch.util.config import Config, load_config

from torch_helpers import CAPS, TINY, batch_args, tiny_data

BACKBONE = ['input_conv', 'unet', 'output_norm', 'semantic_linear',
            'offset_linear']
STEP_CFG = dict(optimizer=dict(type='Adam', lr=0.004), epochs=2,
                step_epoch=1, clip_grad_norm=1.0,
                model=dict(TINY, channels=4, fixed_modules=[]))


def _net() -> SoftGroupNet:
    return SoftGroupNet(channels=4, num_blocks=3, semantic_classes=6,
                        instance_classes=4, bf16=False)


def _init_state() -> dict:
    """The seeded weights of the two CLI steps' test: a port init, its
    offset head zeroed (the shifted points stay on the 1/64 grid), the
    running statistics moved off their init values."""
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
    return {k: v.numpy().copy() for k, v in net.state_dict().items()}


def _no_positives(data: dict) -> dict:
    """``data`` with every instance's class ignored: no proposal can be
    assigned a gt, so the batch has no positives."""
    data = dict(data)
    data['instance_cls'] = np.full_like(data['instance_cls'], -100)
    return data


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rank(rank, world, init_method, job, out):
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=init_method,
                            world_size=world, rank=rank)
    try:
        res = JOBS[job['kind']](rank, world, job)
        with open(f'{out}.{rank}', 'wb') as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _spawn(job, tmp_path, world=2) -> list:
    out = str(tmp_path / 'rank')
    torch.multiprocessing.start_processes(
        _rank, args=(world, f'tcp://localhost:{ddp.free_port()}', job, out),
        nprocs=world, start_method='spawn')
    res = []
    for r in range(world):
        with open(f'{out}.{r}', 'rb') as f:
            res.append(pickle.load(f))
    return res


def _numpy(named) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named}


def _steps_job(rank, world, job):
    """``job['datas'][k][rank]`` through ``len(job['datas'])`` steps of the
    train CLI's state with the group, rank ``rank``'s draws
    ``job['rands'][k][rank]``; before each, one backward of a copy of the
    net on the same batch and draw with no group.  Returns per step the
    averaged logs, gradients before the clip, parameters, buffers and
    bytes reduced, and the local gradients, buffers and logs."""
    cfg = Config(job['cfg'])
    caps = Capacities(**CAPS)
    net = _net()
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in job['state'].items()})
    state, _ = train_cli.build_train_state(net, cfg, caps, 2,
                                           dist.group.WORLD)
    fixed = tuple(cfg.model.fixed_modules)
    seen = []
    clip = torch.nn.utils.clip_grad_norm_

    def keep_grads(ps, max_norm):
        ps = list(ps)
        seen.append(_numpy((k, p.grad) for k, p in net.named_parameters()
                           if p.grad is not None))
        return clip(ps, max_norm)
    torch.nn.utils.clip_grad_norm_ = keep_grads
    out = []
    for datas, rands in zip(job['datas'], job['rands']):
        tb = build_scene_batch(*batch_args(datas[rank]), caps, num_levels=3,
                               device='cpu')
        rand = torch.from_numpy(rands[rank])
        local = copy.deepcopy(net)
        set_train_modes(local, fixed)
        loss, llogs = local.loss_forward(tb, cfg.model, caps, rand=rand)
        loss.backward()
        logs = state.step(tb, rand=rand)
        out.append(dict(
            logs={k: float(v) for k, v in logs.items()}, grads=seen[-1],
            params=_numpy(net.named_parameters()),
            buffers=_numpy(net.named_buffers()),
            reduced=dict(state.step.reduced_bytes),
            local_grads=_numpy((k, p.grad)
                               for k, p in local.named_parameters()
                               if p.grad is not None),
            local_buffers=_numpy(local.named_buffers()),
            local_logs={k: float(v.detach()) for k, v in llogs.items()},
            train_norms=[n for n, m in net.named_modules()
                         if isinstance(m, MaskedBatchNorm) and m.training]))
    return out


def _collect_job(rank, world, job):
    """``collect_results`` of rank-sized lists, and ``average_step`` where
    one rank's parameter has no gradient."""
    merged = ddp.collect_results(
        [f'r{rank}i{i}' for i in range(3 - rank)], rank, world,
        job['dir'])
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(1.0)
        lin.bias.zero_()
    if rank == 0:
        lin(torch.ones(4, 3)).sum().backward()
    logs, nbytes = ddp.average_step(
        list(lin.parameters()), lin,
        {'loss': torch.tensor(float(rank + 1))})
    return dict(merged=merged,
                grads=_numpy((k, p.grad) for k, p in lin.named_parameters()),
                logs={k: float(v) for k, v in logs.items()}, nbytes=nbytes)


JOBS = dict(steps=_steps_job, collect=_collect_job)


# ---------------------------------------------------------------------------
# the reference's mesh step
# ---------------------------------------------------------------------------

def _flax_tree(state: dict) -> dict:
    """The port's state dict as a flax variable tree (numpy leaves)."""
    tree = {'params': {}, 'batch_stats': {}}
    net = _net()
    params = {k for k, _ in net.named_parameters()}
    for key, val in state.items():
        node = tree['params' if key in params else 'batch_stats']
        *path, leaf = key.split('.')
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val.copy()
    return tree


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _leaves(v, prefix + (k,))
        else:
            yield '.'.join(prefix + (k,)), np.asarray(v)


@pytest.fixture(scope='module')
def reference():
    return _reference()


def _reference():
    """``run(state, datas, frozen) -> (per-step logs, batch stats, rands,
    the optax chain, the initial variables)``: the reference's mesh step
    over two virtual CPU devices, compiled once a mode; ``datas[k]`` is
    step k's (rank 0, rank 1) data, its keys split from
    ``PRNGKey(42)``."""
    import jax
    import optax

    from softgroup_tpu.data.padding import build_scene_batch as jax_batch
    from softgroup_tpu.model.softgroup import Capacities as JCaps
    from softgroup_tpu.model.softgroup import SoftGroupNet as JNet
    from softgroup_tpu.parallel.mesh import (TrainState, make_mesh,
                                             make_train_step, shard_batch,
                                             stack_batches)
    from softgroup_tpu.util import optim as jopt
    import jax.numpy as jnp

    jcaps = JCaps(**CAPS)
    mesh = make_mesh(2)
    assert mesh.devices.size == 2
    steps = {}

    def run(state, datas, frozen):
        cfg = Config(_cfg(frozen))
        fixed = list(cfg.model.fixed_modules)
        variables = _flax_tree(state)
        jsched = jopt.cosine_after_step_schedule(0.004, 1, 2, 2)
        tx = optax.chain(
            jopt.clip_by_global_norm(cfg.clip_grad_norm),
            jopt.masked_optimizer(jopt.build_optimizer(
                variables['params'], cfg.optimizer, jsched),
                variables['params'], fixed))
        if frozen not in steps:
            # the frozen backbone's batch norms in eval mode (``_t``)
            jnet = JNet(channels=4, num_blocks=3, semantic_classes=6,
                        instance_classes=4, bf16=False,
                        fixed_modules=tuple(fixed))
            steps[frozen] = make_train_step(jnet, cfg.model, jcaps, tx, mesh,
                                            frozen_modules=tuple(fixed))
        jstate = TrainState(params=variables['params'],
                            batch_stats=variables['batch_stats'],
                            opt_state=tx.init(variables['params']),
                            step=jnp.zeros((), jnp.int32))
        rng = jax.random.PRNGKey(42)
        logs, rands = [], []
        for pair in datas:
            rng, sub = jax.random.split(rng)
            keys = [jax.random.fold_in(sub, r) for r in range(2)]
            rands.append([np.stack([
                np.asarray(jax.random.uniform(k, (3,))),
                np.asarray(jax.random.uniform(jax.random.fold_in(k, 1),
                                              (3,)))]) for k in keys])
            stacked = shard_batch(stack_batches(
                [jax_batch(*batch_args(d), jcaps, num_levels=3)
                 for d in pair]), mesh)
            jstate, jl = steps[frozen](jstate, stacked, sub)
            logs.append({k: float(v) for k, v in jl.items()})
        return logs, dict(_leaves(jstate.batch_stats)), rands, tx, variables
    return run


def _cfg(frozen: bool) -> dict:
    return dict(STEP_CFG, model=dict(STEP_CFG['model'],
                                     fixed_modules=BACKBONE if frozen
                                     else []))


def _check_steps(ranks, ref_logs, ref_stats, tx, variables, frozen):
    """The checks of the module docstring on the ranks' step records."""
    import jax
    import jax.numpy as jnp
    import optax

    r0, r1 = ranks
    state = {k: v for k, v in _leaves(variables['params'])}
    trainable = {k for k in state if k.split('.')[0] not in
                 (BACKBONE if frozen else [])}
    for k_step, (a, b, want) in enumerate(zip(r0, r1, ref_logs)):
        for what in ('params', 'buffers', 'logs', 'grads'):
            assert a[what].keys() == b[what].keys(), what
            for k in a[what]:
                np.testing.assert_array_equal(a[what][k], b[what][k],
                                              err_msg=f'{what} {k}')
        assert set(a['grads']) == trainable
        for k, g in a['grads'].items():
            zero = np.zeros_like(g)
            mean = (a['local_grads'].get(k, zero)
                    + b['local_grads'].get(k, zero)) / 2
            bound = 1e-6 * max(float(np.abs(mean).max()), 1e-30)
            np.testing.assert_allclose(g, mean, rtol=0, atol=bound,
                                       err_msg=k)
        for k in a['logs']:
            np.testing.assert_allclose(
                a['logs'][k], (a['local_logs'][k] + b['local_logs'][k]) / 2,
                rtol=1e-6, err_msg=k)
        assert set(a['logs']) == set(want)
        for k in want:
            np.testing.assert_allclose(a['logs'][k], want[k], rtol=1e-4,
                                       atol=1e-4, err_msg=f'step {k_step} '
                                                          f'{k}')
        n_train = sum(a['params'][k].size for k in trainable)
        assert a['reduced']['grads'] == 4 * n_train
        assert a['reduced']['buffers'] == 8 * sum(
            a['buffers'][f'{n}.mean'].size for n in a['train_norms'])
        assert a['reduced']['logs'] == 4 * len(want)
    for k, v in r0[-1]['buffers'].items():
        np.testing.assert_allclose(v, ref_stats[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)

    @jax.jit
    def update(g, opt_state, p):
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state
    jp = jax.tree.map(jnp.asarray, variables['params'])
    opt_state = tx.init(jp)
    for rec in r0:
        g = {k: jnp.asarray(rec['grads'].get(k, np.zeros_like(v)))
             for k, v in state.items()}
        tree = jax.tree_util.tree_map_with_path(
            lambda path, _: g['.'.join(p.key for p in path)], jp)
        jp, opt_state = update(tree, opt_state, jp)
        for k, want in _leaves(jp):
            np.testing.assert_allclose(rec['params'][k], want, rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def _run_pair(reference, tmp_path, datas, frozen):
    state = _init_state()
    ref_logs, ref_stats, rands, tx, variables = reference(state, datas,
                                                          frozen)
    ranks = _spawn(dict(kind='steps', cfg=_cfg(frozen), state=state,
                        datas=datas, rands=rands), tmp_path)
    _check_steps(ranks, ref_logs, ref_stats, tx, variables, frozen)
    return state, ranks


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_two_rank_steps_match_mesh(reference, tmp_path):
    """(a) Two steps, each rank on its own batch (seeds 1 and 2, then the
    two swapped), all parameters: the reference's mesh step."""
    datas = [[tiny_data(1), tiny_data(2)], [tiny_data(2), tiny_data(1)]]
    _, ranks = _run_pair(reference, tmp_path, datas, frozen=False)
    r0, r1 = ranks
    assert all(r['local_logs']['num_pos'] > 0 for r in r0 + r1)
    # the ranks' own losses differ: two batches, two draws
    assert r0[0]['local_logs']['loss'] != r1[0]['local_logs']['loss']


def test_rank_without_positives(reference, tmp_path):
    """(c) Rank 0's batch has positive proposals, rank 1's none: the step
    completes on both and matches the reference's."""
    datas = [[tiny_data(1), _no_positives(tiny_data(2))]]
    _, ranks = _run_pair(reference, tmp_path, datas, frozen=False)
    assert ranks[0][0]['local_logs']['num_pos'] > 0
    assert ranks[1][0]['local_logs']['num_pos'] == 0
    assert ranks[0][0]['logs']['num_pos'] == \
        ranks[0][0]['local_logs']['num_pos'] / 2


def test_collect_results_and_missing_gradient(tmp_path):
    """(d) ``collect_results`` merges in the reference's order (item i of
    every rank, then item i + 1) on rank 0 only, and world 1 passes
    through as the reference's; ``average_step`` treats a rank's missing
    gradient as zeros."""
    from softgroup_tpu.parallel.mesh import collect_results as jcollect
    r0, r1 = _spawn(dict(kind='collect', dir=str(tmp_path / 'gather')),
                    tmp_path)
    assert r0['merged'] == ['r0i0', 'r1i0', 'r0i1', 'r1i1', 'r0i2']
    assert r1['merged'] is None
    assert ddp.collect_results([1, 2], 0, 1) == jcollect([1, 2], 0, 1)
    for r in (r0, r1):
        np.testing.assert_array_equal(r['grads']['weight'],
                                      np.full((2, 3), 2.0))
        np.testing.assert_array_equal(r['grads']['bias'], [2.0, 2.0])
        assert r['logs'] == {'loss': 1.5}
        assert r['nbytes'] == dict(grads=32, logs=4, buffers=0)


def test_check_devices_refuses_like_make_mesh():
    """(e) More devices than present: ``ValueError``, as ``make_mesh``."""
    from softgroup_tpu.parallel.mesh import make_mesh
    with pytest.raises(ValueError):
        make_mesh(4096)
    for device in ('cpu', 'cuda'):
        with pytest.raises(ValueError, match='requested 4096'):
            ddp.check_devices(4096, device)
    assert ddp.check_devices(2, 'cpu') == 2
    assert ddp.check_devices(0, 'cpu') == 1
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match='requested 0 cuda'):
            ddp.check_devices(0, 'cuda')
        with pytest.raises(ValueError):
            train_cli.main(['unused.yaml', '--num-devices', '2'])


def test_loader_batch_grouping(tmp_path):
    """Rank r of n takes the reference loader's batches k * n + r,
    ``len // n`` of them (``tools/train.py``'s grouping of n consecutive
    batches into a step, the remainder dropped)."""
    from softgroup_tpu.data import build_dataloader as jax_build_dataloader
    from softgroup_tpu.data import build_dataset as jax_build_dataset

    from softgroup_tpu_torch.data import build_dataloader, build_dataset
    from test_cli import _make_config, _make_dataset
    _make_dataset(str(tmp_path / 'data'), n_scans=3)
    cfg = load_config(_make_config(tmp_path, str(tmp_path / 'data')))
    cfg.data.train.repeat = 3         # 9 samples: 4 batches of 2
    ref = jax_build_dataloader(jax_build_dataset(cfg.data.train),
                               batch_size=2, training=True)
    for world in (1, 2, 3):
        for rank in range(world):
            mine = build_dataloader(build_dataset(cfg.data.train),
                                    batch_size=2, training=True,
                                    rank=rank, world=world)
            assert len(mine) == len(ref) // world
            for epoch in (1, 2):
                ref.set_epoch(epoch)
                mine.set_epoch(epoch)
                want = [list(b) for b in ref._batches()]
                assert list(mine.batch_sampler) == want[rank::world][
                    :len(mine)], (world, rank, epoch)
