"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
steady run of items, once per process, with the harness's own host spans
and a recorder around the kernel entry points whose rooflines are read.

What a stretch gives the metric readers (``Trace``):
* ``kernels``: every device activity (kernel, memcpy, memset) as (name,
  start us, duration us, category), and ``launches``: the kernels alone;
* ``busy_s``: the union of those intervals; ``window_s``: the host clock
  from the synchronised start to the synchronised end;
* ``calls``: per recorded entry point, each call's arguments' sizes and the
  device time of its own kernels (a kernel belongs to a call when its
  launch lies inside the call's range on the host);
* ``counts``: what the loop counted (steps, rooms, model FLOPs);
* ``spans``: the harness's host spans (``h2d``, ``dispatch``, ``step``,
  ``forward``, ``copy_out``), by which ``breakdown`` labels idle gaps.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from contextlib import contextmanager, nullcontext

from .roofline import finish

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
CALL_PREFIX = 'portbench.call.'
SPAN_PREFIX = 'portbench.'


class Trace:
    def __init__(self):
        self.kernels = []       # (name, ts, dur, cat)
        self.calls = {}         # entry -> [dict(args=..., kernels=[...])]
        self.lost = {}          # entry -> (calls made, ranges traced)
        self.spans = []         # (name, ts, dur)
        self.counts = {}
        self.busy_s = 0.0
        self.window_s = 0.0
        self.t0_us = 0.0
        self.t1_us = 0.0

    @property
    def launches(self) -> list:
        return [k for k in self.kernels if k[3] == 'kernel']

    def device_time(self, entry: str, pattern: str) -> float:
        """Seconds of the kernels of ``entry``'s calls whose names match
        ``pattern``."""
        rx = re.compile(pattern)
        return sum(d for c in self.calls.get(entry, ())
                   for n, d in c['kernels'] if rx.search(n)) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        totals = {}
        for name, _, dur, _ in self.kernels:
            totals[name] = totals.get(name, 0.0) + dur * 1e-6
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        return dict(device_ops=[[short(n), s] for n, s in ops],
                    idle_gaps=[[lbl, s] for lbl, s in self.idle_gaps(top)])

    def idle_gaps(self, top: int = 10) -> list:
        """The longest stretches with nothing on the device, each labelled
        by the innermost harness span the host was in at its middle."""
        ivs = sorted((ts, ts + dur) for _, ts, dur, _ in self.kernels)
        gaps, end = [], self.t0_us
        for s, e in ivs:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.t1_us > end:
            gaps.append((end, self.t1_us))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            mid = (s + e) / 2
            inside = [(dur, n) for n, ts, dur in self.spans
                      if ts <= mid <= ts + dur]
            out.append((min(inside)[1] if inside else 'host',
                        (e - s) * 1e-6))
        return out


def short(name: str, width: int = 64) -> str:
    return name[:width]


def _union_s(ivs) -> float:
    total, end = 0.0, float('-inf')
    for s, e in sorted(ivs):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total * 1e-6


class Tracer:
    """``span(name)`` marks a host span while a stretch is traced (and is
    free otherwise); ``stretch(sites, counts)`` traces one stretch.
    ``sites``: {entry: (module, attribute, summary)}, where ``summary``
    turns a call's arguments into its sizes (``roofline.k1_call``); the
    rulebook hits it needs are counted after the stretch, so the recorder
    adds no device work inside it."""

    def __init__(self, device):
        self.device = device
        self.active = False
        self.trace = None

    def span(self, name: str):
        if not self.active:
            return nullcontext()
        import torch
        return torch.profiler.record_function(SPAN_PREFIX + name)

    @contextmanager
    def stretch(self, sites: dict):
        import torch
        from torch.profiler import ProfilerActivity, profile
        if self.trace is not None:
            raise RuntimeError('one traced stretch a process')
        trace = self.trace = Trace()
        pending = {e: [] for e in sites}
        saved = []
        for entry, (mod, attr, summary) in sites.items():
            orig = getattr(mod, attr)

            def wrapped(*args, _orig=orig, _entry=entry, _sum=summary, **kw):
                pending[_entry].append(_sum(*args))
                with torch.profiler.record_function(CALL_PREFIX + _entry):
                    return _orig(*args, **kw)
            saved.append((mod, attr, orig))
            setattr(mod, attr, wrapped)
        cuda = self.device.type == 'cuda'
        sync = (lambda: torch.cuda.synchronize(self.device)) if cuda \
            else (lambda: None)
        sync()
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        try:
            prof.__enter__()
            self.active = True
            t0 = time.perf_counter()
            with torch.profiler.record_function(SPAN_PREFIX + 'stretch'):
                yield trace
            sync()
            trace.window_s = time.perf_counter() - t0
        finally:
            self.active = False
            prof.__exit__(None, None, None)
            for mod, attr, orig in saved:
                setattr(mod, attr, orig)
        _read_profile(prof, trace)
        hits = {}

        def hits_of(rules):
            if id(rules) not in hits:
                hits[id(rules)] = int((rules >= 0).sum())
            return hits[id(rules)]
        for entry in sites:
            ranges = trace.calls.pop(entry, [])
            if len(ranges) != len(pending[entry]):
                # a trace that lost call ranges reads no roofline
                trace.lost[entry] = (len(pending[entry]), len(ranges))
                continue
            trace.calls[entry] = [dict(args=finish(a, hits_of), kernels=r)
                                  for a, r in zip(pending[entry], ranges)]
        pending.clear()


def _read_profile(prof, trace: Trace) -> None:
    """Device activity, launches, call ranges and spans from the
    profiler's Chrome trace (written to a temporary file and removed)."""
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    events = events.get('traceEvents', events) \
        if isinstance(events, dict) else events
    launch_ts = {}
    calls = {}
    stretch = None
    for ev in events:
        if ev.get('ph') != 'X':
            continue
        cat, name = ev.get('cat', ''), ev.get('name', '')
        ts, dur = float(ev.get('ts', 0.0)), float(ev.get('dur', 0.0))
        if cat in DEVICE_CATS:
            trace.kernels.append((name, ts, dur, cat))
        elif cat == 'cuda_runtime' or cat == 'cuda_driver':
            corr = ev.get('args', {}).get('correlation')
            if corr is not None:
                launch_ts[corr] = ts
        elif cat == 'user_annotation' and name.startswith(SPAN_PREFIX):
            if name.startswith(CALL_PREFIX):
                calls.setdefault(name[len(CALL_PREFIX):], []).append(
                    (ts, ts + dur))
            elif name == SPAN_PREFIX + 'stretch':
                stretch = (ts, ts + dur)
            else:
                trace.spans.append((name[len(SPAN_PREFIX):], ts, dur))
    if stretch is None:
        raise RuntimeError('the profiler recorded no stretch span')
    trace.t0_us, trace.t1_us = stretch
    for entry, ranges in calls.items():
        ranges.sort()
        owned = [[] for _ in ranges]
        starts = [r[0] for r in ranges]
        for ev in events:
            if ev.get('ph') != 'X' or ev.get('cat') not in DEVICE_CATS:
                continue
            lt = launch_ts.get(ev.get('args', {}).get('correlation'))
            if lt is None:
                continue
            i = bisect.bisect_right(starts, lt) - 1
            if i >= 0 and lt <= ranges[i][1]:
                owned[i].append((ev['name'], float(ev.get('dur', 0.0))))
        trace.calls[entry] = owned
    trace.busy_s = _union_s((ts, ts + dur) for _, ts, dur, _ in trace.kernels)
    trace.t1_us = max(trace.t1_us, trace.t0_us + trace.window_s * 1e6)
