"""The readings of the program's spans (``program_trace.py``): each on a
hand-built trace, the backward link on a CPU profile of a tiny batch norm,
and a tiny traced serve run on the CPU with the program's session open."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, program_trace
from portbench.tracing import Trace

from conftest import SERVE, run_cell, tiny_serve


def _hand_trace() -> Trace:
    """Two items; 1 ms of ``bn`` forward and 2 ms of its backward (on the
    backward thread, 2), 3 ms of grouping, 4 ms of copy, two syncs in the
    stretch and one after it."""
    t = Trace()
    t.counts = dict(steps=2, rooms=2)
    t.spans = [('h2d', 0.0, 5.0)]
    t.program_spans = [('train.forward', 10.0, 100.0, 1),
                       ('bn', 20.0, 10.0, 1),
                       ('model.grouping', 40.0, 20.0, 1),
                       ('postprocess.to_numpy', 70.0, 20.0, 1)]
    t.backward = {'bn': [(200.0, 210.0, 2, 'MulBackward0')]}
    t.launched = [(2.0, 1, 3.0, 4.0, 'copy in'),
                  (25.0, 1, 30.0, 1000.0, 'bn forward'),
                  (205.0, 2, 300.0, 2000.0, 'bn backward'),
                  (205.0, 1, 310.0, 500.0, 'another thread'),
                  (45.0, 1, 50.0, 3000.0, 'grouping'),
                  (75.0, 1, 80.0, 4000.0, 'copy out'),
                  (150.0, 1, 160.0, 100.0, 'outside')]
    t.syncs = [('cudaStreamSynchronize', 50.0, 1),
               ('cudaStreamSynchronize', 80.0, 1),
               ('cudaDeviceSynchronize', 600.0, 1)]
    t.stretch = (0.0, 500.0)
    return t


@pytest.mark.parametrize('name,value', [
    ('bn_ms.train', 1.5), ('grouping_ms.serve', 1.5),
    ('copy_out_ms.serve', 2.0), ('syncs.serve', 1.0)])
def test_reading_on_a_hand_built_trace(name, value):
    t = _hand_trace()
    assert program_trace.READINGS[name](t) == pytest.approx(value)
    # a program without the spans (the harness's trace alone) reads nothing
    bare = Trace()
    bare.counts = dict(steps=2, rooms=2)
    assert program_trace.READINGS[name](bare) is None


def test_owned_share_and_labels_on_a_hand_built_trace():
    t = _hand_trace()
    owned = program_trace.launched_in(t, None, also=('h2d',))
    # launched at 150 and 205 us: outside every span
    assert {a[4] for a in owned} == {'copy in', 'bn forward', 'grouping',
                                     'copy out'}
    t.kernels = [(a[4], a[2], a[3], 'kernel') for a in t.launched]
    t.spans.append(('step', 0.0, 400.0))
    t.t0_us, t.t1_us = 0.0, 2400.0
    labels = dict(program_trace.idle_gaps(t))
    # the gap 7-30 us has its middle in train.forward, inside `step`
    assert 'step/train.forward' in labels


def test_backward_link_on_a_cpu_profile():
    """The autograd functions of a batch norm's ops fall to ``bn``; those
    of the Linear after it, whose first op peeks the same sequence number
    as the batch norm's last one, do not."""
    from softgroup_tpu_torch.model.blocks import MaskedBatchNorm
    from softgroup_tpu_torch.util import trace as program
    torch.manual_seed(0)
    bn, lin = MaskedBatchNorm(4).train(), torch.nn.Linear(4, 3)
    x = torch.randn(16, 4, requires_grad=True)
    mask = torch.rand(16) < 0.8
    with program.session(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        lin(bn(x, mask)).sum().backward()
    t = Trace()
    program_trace.read_events(program_trace.chrome_events(prof), t)
    names = {b[3] for b in t.backward['bn']}
    assert {'MulBackward0', 'DivBackward0', 'SubBackward0',
            'RsqrtBackward0', 'AddBackward0'} <= names
    assert not names & {'AddmmBackward0', 'TBackward0', 'SumBackward0'}
    assert [n for n, _, _, _ in t.program_spans] == ['bn']


def test_a_tiny_traced_serve_run_with_the_session(monkeypatch):
    monkeypatch.setattr(harness, 'Tracer', program_trace.ProgramTracer)
    conf, tr = tiny_serve()
    res, line = run_cell(SERVE, conf, tr, torch.device('cpu'), trace=True)
    t = res.trace
    names = {n for n, _, _, _ in t.program_spans}
    assert {'runner.forward', 'model.backbone', 'bn', 'model.grouping',
            'model.voxelize', 'model.refine',
            'postprocess.to_numpy'} <= names
    assert t.program_counts['grouping.rounds'] > 0
    assert t.program_counts['copy_out.bytes'] > 0
    readings = program_trace.report(t)
    # the CPU has no device activity to read
    assert readings['copy_out_ms.serve'] == 0.0
    assert readings['syncs.serve'] == 0.0
    assert readings['bn_ms.train'] is None
    assert line['attempted'] > 0 and line['failed'] == 0
