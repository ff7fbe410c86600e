"""Discovery by name: every part of a cell is a file found through
BENCHMARK.json, and a new cell, mix or metric is picked up from new files
alone."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from portbench import spec
from portbench.tracing import Trace


def test_every_cell_finds_its_files():
    bench = spec.benchmark()
    for wl in bench['workloads']:
        conf = spec.config(wl['config'])
        assert conf['name'] == wl['config']
        tr = spec.traffic(wl['traffic'])
        loop = spec.loop(tr['loop'])
        assert callable(loop.run) and callable(loop.control_reading)
        spec.reference(conf['reference'])
        assert spec.limits(wl['name'])['limits']
    for entry in bench['configs']:
        assert os.path.isfile(os.path.join(spec.ROOT, entry['file']))


@pytest.mark.parametrize('kind', ['end_to_end', 'per_layer'])
def test_every_metric_is_reported_somewhere(kind):
    bench = spec.benchmark()
    cells = {w['name'] for w in bench['workloads']}
    for m in bench[kind]:
        assert set(m.get('workloads', cells)) <= cells
        if kind == 'per_layer':
            reader = spec.metric_reader(m['name'])
            assert reader.read(Trace()) is None    # nothing to read: silent


def test_per_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    bench = spec.benchmark()
    for m in bench['per_layer']:
        for wl in m['workloads']:
            names = {e['name'] for e in spec.cell_metrics(bench, wl,
                                                          'end_to_end')}
            assert m['moves'] in names


def test_new_files_are_picked_up_without_editing(tmp_path):
    """A dummy configuration, traffic mix, metric and limits, added as new
    files to a copy of the benchmark, are found by name; no existing file
    changes."""
    base = tmp_path / 'portbench'
    shutil.copytree(spec.HERE, base,
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = {p: (base / p).read_bytes() for p in
              ('configs/softgroup_scannet.json', 'traffic/train_stage1.json')}
    conf = spec.config('softgroup_scannet', str(base))
    conf['name'] = 'dummy_net'
    (base / 'configs' / 'dummy_net.json').write_text(json.dumps(conf))
    tr = spec.traffic('train_stage1', str(base))
    tr['rooms_per_batch'] = 2
    (base / 'traffic' / 'dummy_mix.json').write_text(json.dumps(tr))
    (base / 'metrics' / 'dummy.metric.py').write_text(
        'def read(trace):\n    return trace.counts.get("steps")\n')
    (base / 'limits' / 'dummy_cell.json').write_text(
        json.dumps({'limits': {'loss_gap': 1.0}}))
    assert spec.config('dummy_net', str(base))['name'] == 'dummy_net'
    assert spec.traffic('dummy_mix', str(base))['rooms_per_batch'] == 2
    t = Trace()
    t.counts['steps'] = 7
    assert spec.metric_reader('dummy.metric', str(base)).read(t) == 7
    assert spec.limits('dummy_cell', str(base))['limits'] == {'loss_gap': 1.0}
    for p, data in before.items():
        assert (base / p).read_bytes() == data
