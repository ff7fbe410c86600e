"""Device time of ``test_forward`` at the flagship config on one card.

    python -m softgroup_tpu_torch.time_forward [label] [--requests N]

Builds three 250k-point rooms (seeds 100-102) and the seeded flagship net
(semantic head biased as in ``chip_smoke.py`` so grouping and refinement
run), warms up once per room, then times N requests round-robin (host clock
around a synchronised ``test_forward``) and prints one line
``time_forward <label> median=... min=... max=... all=[...]``.  To compare
two versions of the code, run it from each checkout in one session, in
turns (a, b, b, a, ...).
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from . import entry
from .data.synthetic import make_room_scene
from .ops import kernels


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('label', nargs='?', default='')
    ap.add_argument('--requests', type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('time_forward: needs a CUDA card')
    kernels.build_all()
    cfg, caps = entry.flagship_cfg(), entry.bench_capacities()
    net = entry.build_net(cfg, seed=0, device='cuda')
    with torch.no_grad():
        net.semantic_linear.final_bias[2:4] = 2.5
    batches = [entry.build_batch(make_room_scene(np.random.RandomState(s),
                                                 n_points=250000,
                                                 n_instances=12), cfg, caps)
               for s in (100, 101, 102)]
    for b in batches:
        entry.infer(net, b, cfg, caps)
    times = []
    for i in range(args.requests):
        torch.cuda.synchronize()
        t = time.perf_counter()
        entry.infer(net, batches[i % len(batches)], cfg, caps)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    print(f'time_forward {args.label} median={statistics.median(times):.3f} '
          f'min={min(times):.3f} max={max(times):.3f} '
          f'all={[round(t, 3) for t in times]} '
          f'[{torch.cuda.get_device_name(0)}]', flush=True)


if __name__ == '__main__':
    main()
