"""Times of the K1 and K2 kernels at the serving path's shapes on one card,
and the timing helpers ``chip_smoke.py`` uses.

    python -m softgroup_tpu_torch.time_kernels [label] [--fill N,...]
    PYTHONPATH=<other checkout> python softgroup_tpu_torch/time_kernels.py \
        [label]

One 250k-point room (seed 0) goes through ``test_forward`` of the seeded
flagship net (bf16, semantic head biased as in ``chip_smoke.py``) while the
K1 and K2 call sites record their arguments.  Each K1 / K2 case of
``chip_smoke.py`` is then timed three ways and printed as one line
``time_kernels <label> <case> device_ms=... ms=... host_us=...``:
  * device_ms: the kernels' own time a call (the profiler's CUDA time over
    20 calls, divided by 20), without the host's gaps between launches;
  * ms: CUDA events around 10 back-to-back calls of the wrapper, over 10;
  * host_us: the wrapper's CPU time a call, launch included.
K2's cases add ``library_device_ms`` (``torch.index_select``).  ``--fill``
times the deep K1 cases at several values of
``conv_kernel._K1_FILL_BLOCKS`` (the grid size below which a tile's work is
split over several blocks; ``_FILL_BLOCKS`` in a checkout without it).
The second form runs this file's cases on another checkout's package, so
two versions compare on one card in one command, in turns (a, b, b, a).
"""

from __future__ import annotations

import argparse
import time

# the profiler's calls a device time is averaged over
DEVICE_REPS = 20


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """CUDA events around ``reps`` back-to-back calls, over ``reps``."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_rows(prof) -> list[tuple[float, int, str]]:
    """(device ms, calls, name) of every kernel, memset and copy that a
    ``torch.profiler`` session saw on the card."""
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # device activity, no ops
            continue
        us = getattr(ev, 'self_device_time_total', None)
        if us is None:
            us = getattr(ev, 'self_cuda_time_total', 0.0)
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    return rows


def device_ms(fn, reps: int = DEVICE_REPS, tries: int = 3) -> float:
    """The card's time of one call of ``fn``: the device time of every
    kernel, memset and copy of ``reps`` calls under the profiler, over
    ``reps``.  A profiler run whose trace holds no device activity (seen
    once in a few hundred runs) is repeated, up to ``tries`` times in all;
    then this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(r[0] for r in kernel_rows(prof))
        if total > 0:
            return total / reps
    raise RuntimeError(f'the profiler saw no device time in {tries} runs')


def host_us(fn, reps: int = 20) -> float:
    """The host's time of one call of ``fn`` (enqueue, launch included),
    over ``reps`` calls that are not waited for."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e6


class Recorder:
    """Wraps the kernel wrappers at their call sites during one run and
    keeps a clone of the arguments of every call."""

    def __init__(self, sites):
        self.sites = sites          # [(module, attribute name)]
        self.calls: dict[str, list] = {}
        self._saved = []

    def __enter__(self):
        import torch
        for mod, name in self.sites:
            orig = getattr(mod, name)

            def wrapped(*args, _orig=orig, _name=name, **kw):
                keep = [a.detach().clone() if isinstance(a, torch.Tensor)
                        else a for a in args]
                self.calls.setdefault(_name, []).append((keep, kw))
                return _orig(*args, **kw)
            # a wrapper wrapped in its own module counts its launches on
            # this stand-in (recording runs are not the counted main path)
            wrapped.launches = 0
            self._saved.append((mod, name, orig))
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)


def pick(calls, pred, what):
    for args, kw in calls:
        if pred(args, kw):
            return args, kw
    raise RuntimeError(f'no recorded call for {what}')


def k1_k2_args(calls: dict, v0: int, cells: int) -> dict:
    """The K1 and K2 cases of ``chip_smoke.py`` and two mid-level K1 convs,
    by label, from the recorded calls of one request (``v0``: level-0
    voxels, ``cells``: the grouping's cell capacity)."""
    import torch
    conv, gather = calls['rulebook_conv'], calls['row_gather']
    return {
        'K1 L0 subm 32->32': pick(conv, lambda a, k: a[2].shape == (27, v0)
                                  and a[1].shape[1:] == (32, 32), 'L0')[0],
        'K1 L1 subm 64->64': pick(
            conv, lambda a, k: a[2].shape[0] == 27
            and a[1].shape[1:] == (64, 64), 'L1')[0],
        'K1 L2 subm 96->96': pick(
            conv, lambda a, k: a[2].shape[0] == 27
            and a[1].shape[1:] == (96, 96), 'L2')[0],
        'K1 input conv 6->32': pick(conv, lambda a, k: a[1].shape[1] == 6,
                                    'input conv')[0],
        'K1 L5 tail 384->192': pick(
            conv, lambda a, k: a[1].shape[1:] == (384, 192), '384')[0],
        'K1 L6 subm 224->224': pick(
            conv, lambda a, k: a[1].shape[1:] == (224, 224), '224')[0],
        'K1 L0->L1 down 32->64': pick(
            conv, lambda a, k: a[2].shape[0] == 8
            and a[1].shape[1:] == (32, 64), 'down')[0],
        'K2 devoxelize (V0, 32) bf16': pick(
            gather, lambda a, k: a[0].dtype == torch.bfloat16
            and a[0].shape == (v0, 32), 'devoxelize')[0],
        'K2 grouping entries (P, 4) f32': pick(
            gather, lambda a, k: a[0].dtype == torch.float32
            and a[0].shape[1:] == (4,), 'entries')[0],
        'K2 cell labels (m+1,) int32': pick(
            gather, lambda a, k: a[0].dim() == 1
            and a[0].shape[0] == cells + 1, 'labels')[0],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('label', nargs='?', default='')
    ap.add_argument('--fill', default='',
                    help='comma-separated _FILL_BLOCKS values to time the '
                         'deep K1 cases at')
    args = ap.parse_args()
    import numpy as np
    import torch

    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.data.synthetic import make_room_scene
    from softgroup_tpu_torch.model import softgroup as sg
    from softgroup_tpu_torch.ops import conv_kernel as ck
    from softgroup_tpu_torch.ops import gather_kernel as gk
    from softgroup_tpu_torch.ops import grouping, kernels, sparse_conv
    if not torch.cuda.is_available():
        raise SystemExit('time_kernels: needs a CUDA card')
    kernels.build_all()
    cfg, caps = entry.flagship_cfg(), entry.bench_capacities()
    net = entry.build_net(cfg, seed=0, device='cuda')
    with torch.no_grad():
        net.semantic_linear.final_bias[2:4] = 2.5
    batch = entry.build_batch(make_room_scene(np.random.RandomState(0),
                                              n_points=250000,
                                              n_instances=12), cfg, caps)
    sites = [(sparse_conv, 'rulebook_conv'), (gk, 'row_gather'),
             (grouping, 'row_gather'), (sg, 'row_gather')]
    with Recorder(sites) as rec:
        entry.infer(net, batch, cfg, caps)
        torch.cuda.synchronize()
    cases = k1_k2_args(rec.calls, caps.voxels[0], caps.grouping_cells)
    card = torch.cuda.get_device_name(0)
    fills = [int(f) for f in args.fill.split(',') if f] or [None]
    for name, a in cases.items():
        if name.startswith('K1'):
            feats, w, rules = a[0].bfloat16(), a[1].bfloat16(), a[2]
            deep = feats.shape[1] >= 224
            for fill in (fills if deep else [None]):
                if fill is not None:   # bf16 K1's constant, or an older one
                    name_ = ('_K1_FILL_BLOCKS' if hasattr(
                        ck, '_K1_FILL_BLOCKS') else '_FILL_BLOCKS')
                    setattr(ck, name_, fill)
                fn = (lambda f=feats, w_=w, r=rules:
                      ck.rulebook_conv(f, w_, r))
                tag = f' fill={fill}' if fill is not None else ''
                print(f'time_kernels {args.label} {name} bf16{tag} '
                      f'device_ms={device_ms(fn):.6f} ms={cuda_ms(fn):.6f} '
                      f'host_us={host_us(fn):.3f} [{card}]', flush=True)
        else:
            src, idx = a
            idx_l = idx.long().clamp(0, src.shape[0] - 1)
            fn = (lambda s=src, i=idx: gk.row_gather(s, i))
            lib = (lambda s=src, i=idx_l: torch.index_select(s, 0, i))
            print(f'time_kernels {args.label} {name} idx={idx.dtype} '
                  f'device_ms={device_ms(fn):.6f} ms={cuda_ms(fn):.6f} '
                  f'host_us={host_us(fn):.3f} '
                  f'library_device_ms={device_ms(lib):.6f} '
                  f'library_ms={cuda_ms(lib):.6f} [{card}]', flush=True)


if __name__ == '__main__':
    main()
