"""Readings that set a cell's limits, on the card at the cell's own size
(the benchmark's own runs do not run them):

    python -m portbench.control --workload <name> --seconds <s> \
        --seeds 1,2,3 [--control-seeds 4,5,6] [--fault-seeds 7,8,9]

* ``--seeds``: the program as the benchmark runs it (set-up, a window of
  ``--seconds``, the reference's check): the lower readings;
* ``--control-seeds``: the control, the reference computed in float8
  (e4m3) put in the program's place, against the reference in float32
  (the loop's ``control_reading``): it has to fail;
* ``--fault-seeds`` (training): the program with half of each batch left
  out (the loss a mean over the rest), against the reference on the whole
  batch.

A train step that leaves the state unchanged reads 1 on ``change_gap`` by
its definition and needs no run.  One line per reading on standard
output: ``{"kind", "seed", "numbers"}``.
"""

from __future__ import annotations

import argparse
import json
import time

from . import harness, spec


def _ints(text: str) -> list:
    return [int(s) for s in text.split(',') if s]


def program_reading(bench, wl, seed: int, seconds: float) -> dict:
    import torch
    ctx = harness.Context(bench, wl, seed, seconds, False,
                          torch.device('cuda', 0), time.perf_counter())
    res = spec.loop(ctx.traffic['loop']).run(ctx)
    return dict(res.numbers, attempted=res.attempted, failed=res.failed)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seconds', type=float, default=0.0)
    p.add_argument('--seeds', default='')
    p.add_argument('--control-seeds', default='')
    p.add_argument('--fault-seeds', default='')
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('the readings are taken on the card')
    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    loop = spec.loop(spec.traffic(wl['traffic'])['loop'])

    def emit(kind, seed, numbers):
        print(json.dumps(dict(kind=kind, seed=seed, numbers=numbers)),
              flush=True)

    for seed in _ints(args.seeds):
        emit('program', seed, program_reading(bench, wl, seed, args.seconds))
    for seed in _ints(args.control_seeds):
        emit('control_fp8', seed, loop.control_reading(bench, wl, seed))
    if args.fault_seeds:
        from softgroup_tpu_torch import entry
        build = entry.build_train_batch

        def half(scenes, *a, **kw):
            scenes = list(scenes)
            return build(scenes[:len(scenes) // 2], *a, **kw)
        entry.build_train_batch = half
        try:
            for seed in _ints(args.fault_seeds):
                emit('fault_half_batch', seed,
                     program_reading(bench, wl, seed, args.seconds))
        finally:
            entry.build_train_batch = build


if __name__ == '__main__':
    main()
