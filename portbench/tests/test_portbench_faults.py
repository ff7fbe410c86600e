"""A run with the timed path broken underneath reads ``correct`` false,
at tiny sizes on the CPU (the harness's look for a card skipped, every
other part of a run driven), and a sound run reads true."""

from __future__ import annotations

import pytest
import torch

from conftest import (SERVE, TRAIN, assert_sound_serving, run_cell,
                      tiny_serve, tiny_train)

CPU = torch.device('cpu')


def test_sound_training_run_is_correct():
    conf, tr = tiny_train()
    _, line = run_cell(TRAIN, conf, tr, CPU, seconds=0.1)
    assert line['correct'], line['checks']


def test_training_step_that_leaves_the_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, 'step', lambda self, *a, **k: None)
    conf, tr = tiny_train()
    res, line = run_cell(TRAIN, conf, tr, CPU)
    assert res.numbers['change_gap'] == pytest.approx(1.0)
    assert not line['correct']


def test_training_on_half_of_each_batch(monkeypatch):
    from softgroup_tpu_torch import entry
    build = entry.build_train_batch
    monkeypatch.setattr(entry, 'build_train_batch',
                        lambda scenes, *a, **k: build(
                            list(scenes)[:len(scenes) // 2], *a, **k))
    conf, tr = tiny_train()
    _, line = run_cell(TRAIN, conf, tr, CPU)
    assert not line['correct'], line['checks']


def test_training_control_in_float8_fails():
    """The reference computed in float8 in the program's place."""
    from portbench import generator, spec, weights
    from portbench.check import judge, train_numbers
    from portbench.loops.train_closed import reference_steps
    from softgroup_tpu_torch.tools_impl import train_cli
    from softgroup_tpu_torch.util.config import Config
    conf, tr = tiny_train()
    cfg = Config(conf['run'])
    net = train_cli.build_net(cfg, device='cpu')
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    trainable = [n for n, _ in net.named_parameters()]
    seed = 2 ** 31 + 9
    rooms = generator.train_pool(tr, seed, 20)[:tr['checked_steps']]
    w0 = weights.make(shapes, seed, CPU, conf.get('lift'))
    out = {p: reference_steps(conf, cfg, rooms, w0, trainable, CPU, p)
           for p in ('fp8', 'f32')}
    numbers, _ = train_numbers(out['fp8'], out['f32'])
    ok, checks = judge(numbers, spec.limits(TRAIN)['limits'])
    assert not ok, checks


def test_sound_serving_run_is_correct():
    conf, tr = tiny_serve()
    _, line = run_cell(SERVE, conf, tr, CPU, seconds=0.1)
    assert_sound_serving(line)


def test_serving_answer_altered_where_it_is_produced(monkeypatch):
    """A proposal's entries handed to the next proposal in the program's
    grouping."""
    from softgroup_tpu_torch.model import softgroup
    grouping = softgroup.forward_grouping

    def altered(*a, **k):
        p = grouping(*a, **k)
        seg = torch.where(p.entry_valid & (p.entry_seg == 0), 1,
                          p.entry_seg)
        return p._replace(entry_seg=seg.to(p.entry_seg.dtype))
    monkeypatch.setattr(softgroup, 'forward_grouping', altered)
    conf, tr = tiny_serve()
    res, line = run_cell(SERVE, conf, tr, CPU, seconds=0.1)
    assert res.numbers['proposal_mismatch'] > 0
    assert not line['correct'], line['checks']


def test_serving_half_of_the_room_left_out(monkeypatch):
    """Half of the room's points marked invalid in the program's batch:
    the heads' batch statistics and grouping see the rest alone."""
    from softgroup_tpu_torch.tools_impl.test_runner import InferenceRunner
    build = InferenceRunner.build_batch

    def half(self, data, *a, **k):
        batch, caps = build(self, data, *a, **k)
        valid = batch.pyramid.point_valid.clone()
        n = int(valid.sum())
        valid[n // 2:] = False
        batch.pyramid.point_valid = valid
        return batch, caps
    monkeypatch.setattr(InferenceRunner, 'build_batch', half)
    conf, tr = tiny_serve()
    _, line = run_cell(SERVE, conf, tr, CPU, seconds=0.1)
    assert not line['correct'], line['checks']
