"""What every loop shares: the run's context (its cell, seed and
window), the timed phases of the set-up, the log on standard error, and
the result line the run prints last.

A loop (``loops/<name>.py``) gets a ``Context`` and returns a ``Result``;
``run.py`` turns that into the last line of standard output.
"""

from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass

from . import spec
from .tracing import Tracer


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Context:
    """One run of one cell: ``bench`` (BENCHMARK.json), ``wl`` (the
    workload entry), ``config`` and ``traffic`` (their files), ``limits``,
    ``seed``, ``seconds``, ``trace``, ``device`` and ``t_start`` (the
    process's start on the host clock: set-up runs from there)."""

    def __init__(self, bench: dict, wl: dict, seed: int, seconds: float,
                 trace: bool, device, t_start: float,
                 config: dict | None = None, traffic: dict | None = None,
                 limits: dict | None = None):
        self.bench, self.wl = bench, wl
        self.config = config or spec.config(wl['config'])
        self.traffic = traffic or spec.traffic(wl['traffic'])
        self.limits = (limits or spec.limits(wl['name']))['limits']
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.t_start = t_start
        self.setup = {}
        self.tracer = Tracer(device)

    @contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.setup[name] = time.perf_counter() - t

    def span(self, name: str):
        return self.tracer.span(name)


@dataclass
class Result:
    attempted: int
    failed: int
    end_to_end: dict            # name -> value
    setup_s: float
    memory_peak_bytes: int
    numbers: dict               # what decides `correct`
    trace: object = None        # tracing.Trace of a --trace 1 run


def result_line(ctx: Context, res: Result, device_info: dict) -> dict:
    """The run's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, (traced) ``breakdown``, and ``checks`` last."""
    from .check import judge
    correct, checks = judge(res.numbers, ctx.limits)
    correct &= res.failed == 0 and res.attempted > 0
    metrics = {}
    if not ctx.trace:
        e2e = spec.cell_metrics(ctx.bench, ctx.wl['name'], 'end_to_end')
        values = dict(res.end_to_end, setup_s=res.setup_s)
        for m in e2e:
            metrics[m['name']] = dict(value=values[m['name']],
                                      unit=m['unit'])
    else:
        for m in spec.cell_metrics(ctx.bench, ctx.wl['name'], 'per_layer'):
            value = spec.metric_reader(m['name']).read(res.trace)
            if value is not None:
                metrics[m['name']] = dict(value=value, unit=m['unit'])
    device = dict(device_info, memory_peak_bytes=res.memory_peak_bytes)
    line = dict(correct=bool(correct), attempted=res.attempted,
                failed=res.failed, metrics=metrics, device=device)
    if ctx.trace:
        device.update(busy_s=res.trace.busy_s, window_s=res.trace.window_s)
        line['breakdown'] = res.trace.breakdown()
    line['checks'] = checks
    return line


def print_result(line: dict) -> None:
    for name, c in line['checks'].items():
        log(f'[check] {name} {c["value"]!r} limit {c["limit"]!r}')
    print(json.dumps(line), flush=True)
