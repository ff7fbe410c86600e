"""Shared fixtures of the benchmark's tests: tiny cells on the CPU (or the
card), run through the harness as the benchmark runs them."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from portbench import harness, spec

TRAIN, SERVE = 'scannet_train_stage1', 's3dis_serve'
TINY_TRAIN_POINTS = 3000
TINY_SERVE_POINTS = 20000


def tiny_train(points: int = TINY_TRAIN_POINTS):
    """(config, traffic) of the train cell at a CPU size: 3 batches of 2
    rooms, level caps that fit them."""
    wl = spec.workload(spec.benchmark(), TRAIN)
    conf = copy.deepcopy(spec.config(wl['config']))
    tr = copy.deepcopy(spec.traffic(wl['traffic']))
    tr['rooms'].update(points=points, instances=4)
    tr.update(batches=3, rooms_per_batch=2, trace_items=2)
    conf['run']['tpu']['caps'].update(
        points=16384, voxels=[8192] * 4 + [4096, 2048, 1024])
    return conf, tr


def tiny_serve(points: int = TINY_SERVE_POINTS):
    """(config, traffic) of the serve cell at a CPU size: 2 rooms, the
    class-size threshold scaled with the rooms, small proposal grids."""
    wl = spec.workload(spec.benchmark(), SERVE)
    conf = copy.deepcopy(spec.config(wl['config']))
    tr = copy.deepcopy(spec.traffic(wl['traffic']))
    tr['rooms'].update(points=points, instances=6)
    tr.update(sample=1, trace_items=2)
    conf['run']['model']['grouping_cfg']['npoint_thr'] *= points / 1e6
    conf['run']['tpu']['caps']['inst_voxels'] = [8192, 2048]
    return conf, tr


def run_cell(name: str, conf: dict, tr: dict, device, seed: int = 2 ** 31 + 9,
             seconds: float = 0.0, trace: bool = False):
    """(result, result line) of one run of a tiny cell in this process."""
    from portbench.loops import serve_closed
    bench = spec.benchmark()
    wl = spec.workload(bench, name)
    ctx = harness.Context(bench, wl, seed, seconds, trace, device,
                          time.perf_counter(), config=conf, traffic=tr)
    saved = serve_closed.SAMPLE_FROM
    serve_closed.SAMPLE_FROM = 1
    try:
        res = spec.loop(tr['loop']).run(ctx)
    finally:
        serve_closed.SAMPLE_FROM = saved
    line = harness.result_line(ctx, res, dict(platform=device.type,
                                              kind=str(device), count=1))
    return res, line


def assert_sound_serving(line: dict) -> None:
    """Every number of a tiny serving run within its limit but
    ``semantic_gap``: at the tiny size the semantic heads spread over a
    few bf16 steps of the lifted bias, so the program's rounding reads
    ~0.85 of that spread (0.05-0.15 at the cell's size on the card)."""
    for name, c in line['checks'].items():
        if name != 'semantic_gap':
            assert c['value'] <= c['limit'], (name, c)
    assert line['failed'] == 0 and line['attempted'] > 0


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)
