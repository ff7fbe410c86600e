"""The program's own spans and counters (``softgroup_tpu_torch/util/
trace.py``) in the traced stretch of one cell:

    python3 -m portbench.program_trace --workload <name> --seed <n> \
        --seconds <s>

runs the cell as ``python3 -m portbench.run ... --trace 1`` does (the same
loop, stretch, checks and result line), with the program's trace session
open over the traced stretch, and then reads the stretch's profile for
what the program marked.  Standard error gets ``[trace]`` lines: the
program's counters, the blocking runtime calls grouped by innermost
program span, ``bn``'s forward and backward device ms apart, the share of
the device's busy time launched inside a program span (or the harness's
``h2d``), the longest idle gaps labelled ``<harness span>/<innermost
program span>``, the earliest start of a kernel of ``model.grouping`` and
``postprocess.to_numpy`` against its span's start, and four readings.
The last line of standard output is ``{"program_trace": {...}}`` with
those readings.

What is read from the profile's Chrome trace (``read_events``), kept on
the ``Trace`` beside what ``tracing.py`` reads:
* ``program_spans``: the ``sg.`` user annotations (name, ts, dur, tid);
* ``syncs``: the blocking runtime calls (``SYNC_CALLS``) as (name, ts,
  tid);
* ``launched``: each device activity as (launch ts, launch tid, start,
  duration, name): a kernel belongs to a range when its launch's runtime
  call lies inside it;
* ``backward``: per span of ``BACKWARD_OF``, the ranges (ts, end, tid,
  name) of the autograd functions (``autograd::engine::evaluate_function:
  ...``) whose forward op ran inside that span, linked by the op's
  ``Sequence number`` (one forward thread);
* ``program_counts``: the session's counters.

The readings (per step or room of ``Trace.counts``; None where the spans
they read are absent, as on a program without them):
* ``bn_ms.train``: device ms a step launched inside ``bn`` spans and
  inside the backward functions of their ops;
* ``copy_out_ms.serve``: device ms a room inside ``postprocess.to_numpy``;
* ``grouping_ms.serve``: device ms a room inside ``model.grouping``;
* ``syncs.serve``: blocking runtime calls inside the stretch, a room.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
from contextlib import contextmanager

from portbench import run  # noqa: I100 (sets the caches before torch)
from portbench import harness, tracing

PROGRAM_PREFIX = 'sg.'
SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize', 'cudaMemcpy')
BACKWARD = 'autograd::engine::evaluate_function: '
BACKWARD_OF = ('bn',)
STRETCH = tracing.SPAN_PREFIX + 'stretch'


def _load(path: str) -> list:
    with open(path) as f:
        events = json.load(f)
    return events.get('traceEvents', []) if isinstance(events, dict) \
        else events


def chrome_events(prof) -> list:
    """The profiler's Chrome trace events (through a temporary file; a
    profile exports once)."""
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return _load(path)
    finally:
        os.remove(path)


def read_events(events: list, trace) -> None:
    """Sets ``program_spans``, ``syncs``, ``launched``, ``backward``,
    ``runtime_calls`` (name -> calls) and ``stretch`` (the harness's
    stretch range, or None) on ``trace``."""
    spans, syncs, devs, bwd = [], [], [], []
    launch, runtime = {}, {}
    last_op = {}            # sequence number -> (ts, tid) of its last op
    stretch = None
    for ev in events:
        if ev.get('ph') != 'X':
            continue
        cat, name = ev.get('cat', ''), ev.get('name', '')
        ts, dur = float(ev.get('ts', 0.0)), float(ev.get('dur', 0.0))
        tid, args = ev.get('tid'), ev.get('args', {})
        if cat in tracing.DEVICE_CATS:
            devs.append((args.get('correlation'), ts, dur, name))
        elif cat in ('cuda_runtime', 'cuda_driver'):
            if args.get('correlation') is not None:
                launch[args['correlation']] = (ts, tid)
            runtime[name] = runtime.get(name, 0) + 1
            if name in SYNC_CALLS:
                syncs.append((name, ts, tid))
        elif cat == 'user_annotation':
            if name.startswith(PROGRAM_PREFIX):
                spans.append((name[len(PROGRAM_PREFIX):], ts, dur, tid))
            elif name == STRETCH:
                stretch = (ts, ts + dur)
        elif cat == 'cpu_op' and 'Sequence number' in args:
            seq = args['Sequence number']
            if name.startswith(BACKWARD):
                bwd.append((seq, ts, ts + dur, tid,
                            name[len(BACKWARD):]))
            elif args.get('Fwd thread id', 0) == 0 \
                    and ts >= last_op.get(seq, (float('-inf'),))[0]:
                # a forward op (a backward function carries its forward
                # thread's id); the one that made the autograd node is
                # the last to carry its number: the counter moves on then
                last_op[seq] = (ts, tid)
    trace.program_spans = spans
    trace.syncs = syncs
    trace.runtime_calls = runtime
    trace.stretch = stretch
    trace.launched = [(launch[c][0], launch[c][1], ts, dur, name)
                      for c, ts, dur, name in devs if c in launch]
    trace.backward = {}
    for owner in BACKWARD_OF:
        inside = Ranges((ts, ts + dur, tid) for n, ts, dur, tid in spans
                        if n == owner)
        seqs = {s for s, (ts, tid) in last_op.items()
                if inside.covers(ts, tid)}
        trace.backward[owner] = [b[1:] for b in bwd if b[0] in seqs]


class Ranges:
    """Host time ranges (ts, end[, tid]), merged: ``covers(t, tid)``
    whether one holds ``t`` (on thread ``tid`` where the ranges carry
    one)."""

    def __init__(self, ranges):
        by_tid = {}
        for r in ranges:
            by_tid.setdefault(r[2] if len(r) > 2 else None, []).append(
                (r[0], r[1]))
        self._by_tid = {}
        for tid, rs in by_tid.items():
            merged = []
            for s, e in sorted(rs):
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self._by_tid[tid] = ([m[0] for m in merged],
                                 [m[1] for m in merged])

    def covers(self, t: float, tid=None) -> bool:
        for key in {None, tid}:
            starts, ends = self._by_tid.get(key, ((), ()))
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ends[i]:
                return True
        return False


def launched_in(trace, name: str | None = None, backward: bool = False,
                also=()) -> list:
    """The device activities (launch ts, launch tid, start, dur, name)
    launched inside a program span ``name`` (any program span where None)
    on any thread, the harness spans named in ``also``, and, with
    ``backward``, the backward functions of the ops of ``name``."""
    fwd = Ranges([(ts, ts + dur) for n, ts, dur, _ in trace.program_spans
                  if name is None or n == name]
                 + [(ts, ts + dur) for n, ts, dur in trace.spans
                    if n in also])
    bwd = Ranges(trace.backward.get(name, []) if backward else [])
    return [a for a in trace.launched
            if fwd.covers(a[0]) or bwd.covers(a[0], a[1])]


def _device_ms(acts) -> float:
    return sum(a[3] for a in acts) * 1e-3


def _has(trace, name: str) -> bool:
    spans = getattr(trace, 'program_spans', None)
    return bool(spans) and any(n == name for n, _, _, _ in spans)


def bn_ms_train(trace):
    steps = trace.counts.get('steps')
    if not steps or not _has(trace, 'bn'):
        return None
    return _device_ms(launched_in(trace, 'bn', backward=True)) / steps


def copy_out_ms_serve(trace):
    rooms = trace.counts.get('rooms')
    if not rooms or not _has(trace, 'postprocess.to_numpy'):
        return None
    return _device_ms(launched_in(trace, 'postprocess.to_numpy')) / rooms


def grouping_ms_serve(trace):
    rooms = trace.counts.get('rooms')
    if not rooms or not _has(trace, 'model.grouping'):
        return None
    return _device_ms(launched_in(trace, 'model.grouping')) / rooms


def syncs_serve(trace):
    rooms = trace.counts.get('rooms')
    if not rooms or getattr(trace, 'stretch', None) is None \
            or not getattr(trace, 'program_spans', None):
        return None
    t0, t1 = trace.stretch
    return sum(t0 <= ts <= t1 for _, ts, _ in trace.syncs) / rooms


READINGS = {'bn_ms.train': bn_ms_train,
            'copy_out_ms.serve': copy_out_ms_serve,
            'grouping_ms.serve': grouping_ms_serve,
            'syncs.serve': syncs_serve}


def innermost(trace, t: float, tid=None) -> str | None:
    """The shortest program span holding host time ``t`` (on ``tid``
    where given)."""
    inside = [(dur, n) for n, ts, dur, th in trace.program_spans
              if ts <= t <= ts + dur and (tid is None or th == tid)]
    return min(inside)[1] if inside else None


def idle_gaps(trace, top: int = 10) -> list:
    """``Trace.idle_gaps`` with the innermost program span at each gap's
    middle appended to its label: [(label, seconds)]."""
    ivs = sorted((ts, ts + dur) for _, ts, dur, _ in trace.kernels)
    gaps, end = [], trace.t0_us
    for s, e in ivs:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if trace.t1_us > end:
        gaps.append((end, trace.t1_us))
    gaps.sort(key=lambda g: g[0] - g[1])     # Trace.idle_gaps's order
    out = []
    for (label, secs), (s, e) in zip(trace.idle_gaps(top), gaps):
        prog = innermost(trace, (s + e) / 2)
        out.append((label + ('/' + prog if prog else ''), secs))
    return out


def report(trace) -> dict:
    """Logs the ``[trace]`` lines of the program's spans; returns the
    readings."""
    log = harness.log
    items = trace.counts.get('steps') or trace.counts.get('rooms') or 1
    log(f'[trace] program counters {trace.program_counts} over {items} '
        f'items')
    by_span = {}
    for _, ts, tid in trace.syncs:
        key = innermost(trace, ts, tid) or 'none'
        by_span[key] = by_span.get(key, 0) + 1
    names = {}
    for n, _, _ in trace.syncs:
        names[n] = names.get(n, 0) + 1
    log(f'[trace] blocking runtime calls {names}; by innermost program '
        f'span {dict(sorted(by_span.items(), key=lambda kv: -kv[1]))}; '
        f'every runtime call {trace.runtime_calls}')
    if _has(trace, 'bn'):
        fwd = _device_ms(launched_in(trace, 'bn'))
        both = _device_ms(launched_in(trace, 'bn', backward=True))
        log(f'[trace] bn forward {fwd / items:.4f} ms, backward '
            f'{(both - fwd) / items:.4f} ms a step; backward functions '
            f'linked {len(trace.backward.get("bn", []))}')
    busy = tracing._union_s((a[2], a[2] + a[3]) for a in trace.launched)
    owned = tracing._union_s((a[2], a[2] + a[3]) for a in launched_in(
        trace, None, also=('h2d',)))
    log(f'[trace] program spans (and h2d) own {owned:.6f} s of '
        f'{busy:.6f} s busy: {100 * owned / busy if busy else 0:.3f}%')
    for name in sorted({n for n, _, _, _ in trace.program_spans}):
        acts = launched_in(trace, name)
        log(f'[trace] span {name}: {_device_ms(acts) / items:.4f} device ms '
            f'an item, {len(acts) / items:.1f} activities')
    if trace.launched:
        least = min(trace.launched, key=lambda a: a[2] - a[0])
        log(f'[trace] clock: device start minus launch, least '
            f'{least[2] - least[0]:.3f} us ({least[4][:60]}) over '
            f'{len(trace.launched)} activities')
    for name in ('model.grouping', 'postprocess.to_numpy'):
        starts = [ts for n, ts, _, _ in trace.program_spans if n == name]
        acts = launched_in(trace, name) if starts else []
        lead = [a[2] - max(s for s in starts if s <= a[0]) for a in acts]
        early = [(a[4][:40], round(a[2] - a[0], 3))
                 for a, d in zip(acts, lead) if d < 0]
        if lead:
            log(f'[trace] clock: {name} activities start {min(lead):.3f} us '
                f'or more after their span starts ({len(lead)} activities, '
                f'{len(early)} before it: {early[:4]})')
    log('[trace] idle gaps ' + ', '.join(
        f'{lbl} {s * 1e3:.3f} ms' for lbl, s in idle_gaps(trace)))
    readings = {k: f(trace) for k, f in READINGS.items()}
    log(f'[trace] readings {readings}')
    return readings


class ProgramTracer(tracing.Tracer):
    """``tracing.Tracer`` with the program's trace session open over the
    stretch; the Chrome trace that ``tracing.py`` exports (a profile
    exports once) is read once more for the program's spans
    (``read_events``)."""

    @contextmanager
    def stretch(self, sites: dict):
        from softgroup_tpu_torch.util import trace as program
        kept = []
        read = tracing._read_profile

        def read_and_keep(prof, trace):
            export = prof.export_chrome_trace

            def export_and_keep(path, *args, **kwargs):
                export(path, *args, **kwargs)
                kept.extend(_load(path))
            prof.export_chrome_trace = export_and_keep
            read(prof, trace)
        tracing._read_profile = read_and_keep
        try:
            with program.session() as s, super().stretch(sites) as trace:
                yield trace
        finally:
            tracing._read_profile = read
        read_events(kept, trace)
        trace.program_counts = dict(s.counters)


def main(argv=None) -> int:
    made = []

    def tracer(device):
        made.append(ProgramTracer(device))
        return made[-1]
    harness.Tracer = tracer
    argv = list(sys.argv[1:] if argv is None else argv)
    rc = run.main(argv + ['--trace', '1'])
    if rc == 0 and made and made[0].trace is not None:
        readings = report(made[0].trace)
        print(json.dumps(dict(program_trace=readings)), flush=True)
    return rc


if __name__ == '__main__':
    sys.exit(main())
