"""Discovery by name: the harness finds every part of a cell through
``BENCHMARK.json`` and files named after the entries there.

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: a mix's parameters, read by ``generator``;
  its ``loop`` names ``loops/<loop>.py``, which drives the cell;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(trace)``;
* ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct``;
* ``reference/<name>.py``: a configuration's plain reference.

Adding a cell, a mix or a metric adds files and entries; no file that is
there changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, 'BENCHMARK.json'))


def workload(bench: dict, name: str) -> dict:
    for w in bench['workloads']:
        if w['name'] == name:
            return w
    raise KeyError(f'no workload {name} in BENCHMARK.json')


def config(name: str, base: str = HERE) -> dict:
    return _json(os.path.join(base, 'configs', f'{name}.json'))


def traffic(name: str, base: str = HERE) -> dict:
    return _json(os.path.join(base, 'traffic', f'{name}.json'))


def limits(workload_name: str, base: str = HERE) -> dict:
    return _json(os.path.join(base, 'limits', f'{workload_name}.json'))


def _load(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(name: str):
    return importlib.import_module(f'portbench.loops.{name}')


def reference(name: str):
    return importlib.import_module(f'portbench.reference.{name}')


def metric_reader(name: str, base: str = HERE):
    """The reader module of a per-layer metric (its file name may hold
    dots, so it is loaded by path)."""
    return _load(os.path.join(base, 'metrics', f'{name}.py'),
                 'portbench_metric_' + name.replace('.', '_'))


def cell_metrics(bench: dict, wl_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``wl_name``
    reports: those that list it, or list no cells."""
    return [m for m in bench[kind]
            if wl_name in m.get('workloads', [wl_name])]
