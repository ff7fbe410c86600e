"""The port's spans and counters (``util/trace.py``) on the CPU, on the tiny
config of ``torch_helpers``: free without a session, nested as the layers
are inside one, counting what the grouping loops and the output copy do,
and leaving every output bit for bit as it was."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from softgroup_tpu_torch import entry
from softgroup_tpu_torch.data.padding import build_scene_batch
from softgroup_tpu_torch.evaluation.postprocess import to_numpy
from softgroup_tpu_torch.model.softgroup import Capacities, SoftGroupNet
from softgroup_tpu_torch.ops import grouping
from softgroup_tpu_torch.parallel.ddp import free_port
from softgroup_tpu_torch.tools_impl.test_runner import InferenceRunner
from softgroup_tpu_torch.util import trace

from torch_helpers import CAPS, batch_args, tiny_cfg, tiny_data

STEP_SPANS = ('train.forward', 'train.backward', 'train.optimizer', 'bn',
              'model.backbone', 'conv.row_order', 'model.grouping',
              'model.voxelize', 'model.refine')
FORWARD_SPANS = ('runner.forward', 'model.backbone', 'conv.row_order', 'bn',
                 'model.grouping', 'model.voxelize', 'model.refine',
                 'postprocess.to_numpy')


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(2, saved))
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def data():
    d = tiny_data()
    d['scan_ids'] = ['tiny']
    return d


@pytest.fixture(scope='module')
def batch(data):
    return build_scene_batch(*batch_args(data), Capacities(**CAPS),
                             num_levels=3, device='cpu')


def _net() -> SoftGroupNet:
    return SoftGroupNet(channels=8, num_blocks=3, semantic_classes=6,
                        instance_classes=4, bf16=False,
                        generator=torch.Generator().manual_seed(0))


def _step(net, batch, group=None):
    """One Adam step of ``net`` on ``batch``: (its logs, its parameters)."""
    state = entry.build_train_state(net, tiny_cfg(), Capacities(**CAPS),
                                    group=group)
    logs = state.step(batch, rand=torch.full((2, 3), 0.5))
    return logs, {k: v.detach().clone() for k, v in net.state_dict().items()}


def _serve(net, batch):
    runner = InferenceRunner(net.eval(), tiny_cfg(), Capacities(**CAPS), 3,
                             device='cpu')
    return to_numpy(runner.forward(batch, Capacities(**CAPS)))


def _chain(rec):
    names = []
    while rec is not None:
        names.append(rec.name)
        rec = rec.parent
    return names


def _sg_events(prof) -> list:
    return [e.name for e in prof.events() if e.name.startswith(trace.PREFIX)]


def test_no_session_is_free(batch):
    """Without a session a span is the one shared no-op, a count records
    nothing, and a profile of a forward holds no ``sg.`` range."""
    assert not trace.active()
    assert trace.span('bn') is trace.span('model.grouping')
    with trace.span('bn') as rec:
        assert rec is None
    trace.count('grouping.rounds')
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(_net(), batch)
    assert _sg_events(prof) == []


def test_one_session_at_a_time():
    with trace.session() as s:
        with pytest.raises(RuntimeError):
            with trace.session():
                pass
        trace.count('x', 3)
        trace.count('x')
    assert s.counters == {'x': 4} and not trace.active()


def test_spans_nest_in_a_train_step_and_a_forward(batch):
    """A session under a CPU profiler over one train step and one served
    forward: every span is there, on the profile too, and nested as the
    layers call each other."""
    with trace.session() as s, profile(
            activities=[ProfilerActivity.CPU]) as prof:
        _step(_net(), batch)
        n_step = len(s.spans)
        _serve(_net(), batch)
    step, fwd = s.spans[:n_step], s.spans[n_step:]
    assert {r.name for r in step} == set(STEP_SPANS)
    assert {r.name for r in fwd} == set(FORWARD_SPANS)
    for r in step:
        assert r.start_ns <= r.end_ns
        if r.name in ('bn', 'model.backbone', 'model.grouping',
                      'conv.row_order'):
            assert _chain(r)[-1] == 'train.forward', _chain(r)
        if r.name == 'conv.row_order':   # before a U-Net takes its levels
            assert r.parent.name in ('model.backbone', 'model.refine')
        if r.parent is not None:
            assert r.parent.start_ns <= r.start_ns <= r.end_ns \
                <= r.parent.end_ns
    for r in fwd:
        if r.name.startswith('model.') or r.name == 'bn':
            assert _chain(r)[-1] == 'runner.forward', _chain(r)
    grouping_rec = next(r for r in fwd if r.name == 'model.grouping')
    assert grouping_rec.parent.name == 'runner.forward'
    assert sorted(_sg_events(prof)) == sorted(
        trace.PREFIX + r.name for r in s.spans)


def test_outputs_bit_equal_with_and_without_session(batch):
    logs0, params0 = _step(_net(), batch)
    out0 = _serve(_net(), batch)
    with trace.session():
        logs1, params1 = _step(_net(), batch)
        out1 = _serve(_net(), batch)
    assert logs0.keys() == logs1.keys() and params0.keys() == params1.keys()
    for k in logs0:
        assert torch.equal(logs0[k], logs1[k]), k
    for k in params0:
        assert torch.equal(params0[k], params1[k]), k
    assert out0.keys() == out1.keys()
    for k in out0:
        np.testing.assert_array_equal(out0[k], out1[k], err_msg=k)
    assert int(out0['n_proposals']) > 0


def _cells():
    rng = np.random.RandomState(15)
    n = 4096
    centers = rng.rand(12, 3) * 3
    pts = centers[rng.randint(0, 12, n)] + rng.randn(n, 3) * 0.08
    pts = torch.from_numpy((np.round(pts * 64) / 64).astype(np.float32))
    group = torch.from_numpy(rng.randint(0, 8, n).astype(np.int32))
    valid = torch.from_numpy(rng.rand(n) < 0.95)
    return pts, group, valid


@pytest.mark.parametrize('route', ['cells', 'ball'])
def test_grouping_rounds_counts_each_round(route, monkeypatch):
    """``grouping.rounds`` = the propagation rounds the loop ran, each
    ending in its one host read: ``Tensor.any`` (cells) or ``torch.equal``
    (ball), neither called elsewhere on the route."""
    reads = []
    owner, name = (torch.Tensor, 'any') if route == 'cells' \
        else (torch, 'equal')
    read = getattr(owner, name)

    def counted(*args, **kwargs):
        reads.append(1)
        return read(*args, **kwargs)
    monkeypatch.setattr(owner, name, counted)
    pts, group, valid = _cells()
    with trace.session() as s:
        if route == 'cells':
            grouping.cell_cluster_csr(
                pts, group, valid, torch.arange(len(pts), dtype=torch.int32),
                torch.full((4,), 5.0), 0.1, cell_scale=1.0, pair_keys=False)
        else:
            grouping.ball_cluster(pts, group, valid, 0.04)
    assert len(reads) > 1
    assert s.counters == {'grouping.rounds': len(reads)}


def test_copy_out_bytes_are_the_arrays_nbytes():
    out = dict(a=torch.zeros((5, 3)), b=torch.arange(7),
               c=torch.ones(4, dtype=torch.bool), d=torch.tensor(3))
    with trace.session() as s:
        host = to_numpy(out)
    assert s.counters == {'copy_out.bytes':
                          sum(a.nbytes for a in host.values())}
    assert s.counters['copy_out.bytes'] == 5 * 3 * 4 + 7 * 8 + 4 + 8
    assert [r.name for r in s.spans] == ['postprocess.to_numpy']


def test_run_scene_stats_from_its_spans(data):
    """``run_scene`` opens a session for its stats where none is open,
    and records into an open one otherwise."""
    runner = InferenceRunner(_net().eval(), tiny_cfg(), Capacities(**CAPS),
                             3, device='cpu')
    stats = {}
    runner.run_scene(copy.deepcopy(data), stats=stats)
    assert not trace.active()
    for k in ('host_batch_ms', 'forward_ms', 'postprocess_ms'):
        assert stats[k] > 0, k
    stats = {}
    with trace.session() as s:
        runner.run_scene(copy.deepcopy(data), stats=stats)
    by = {r.name: r for r in s.spans}
    assert stats['host_batch_ms'] == by['runner.host_batch'].ms
    assert stats['postprocess_ms'] == by['runner.postprocess'].ms
    assert by['runner.host_batch'].end_ns <= by['runner.forward'].start_ns
    assert stats['forward_ms'] >= by['runner.forward'].ms
    assert by['postprocess.to_numpy'].parent is by['runner.postprocess']
    with trace.session() as s:
        runner.run_scene(copy.deepcopy(data))
    assert {'runner.host_batch', 'runner.forward', 'runner.postprocess'} \
        <= {r.name for r in s.spans}


def test_ddp_spans_in_a_step_over_a_group(batch):
    """A step over a one-rank gloo group records the three all-reduce
    spans between the backward and the optimizer."""
    dist.init_process_group('gloo', init_method=f'tcp://localhost:'
                            f'{free_port()}', rank=0, world_size=1)
    try:
        with trace.session() as s:
            _step(_net(), batch, group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    top = [r.name for r in s.spans if r.parent is None]
    assert top == ['train.forward', 'train.backward', 'ddp.grad_allreduce',
                   'ddp.log_allreduce', 'ddp.buffer_allreduce',
                   'train.optimizer']
