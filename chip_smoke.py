#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. the card's name and power limit; build the CUDA kernels (one nvcc per
     source, in parallel) and print the build time;
  2. a warm-up request of the flagship model records the arguments each
     kernel gets on the main path; each kernel is then held against its
     plain PyTorch version on those inputs (max-abs error, tolerance,
     kernel / plain / library ms, and the bound of the card);
  3. the main path: >= 3 requests (host batch -> test_forward on the card
     -> get_instances) of 250k-point rooms at full flagship width, with
     every launch counter set to 0 just before and read just after;
  4. a small input through the card (f32) against the same port on the CPU
     (plain PyTorch versions of every kernel).
The line before the last is one JSON object of per-kernel numbers; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# card peaks used for the bounds (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
N_REQUESTS = 3
SEMANTIC_BIAS = 2.5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Recorder:
    """Wraps the kernel wrappers at their call sites during one request and
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
                keep = [a.clone() if isinstance(a, torch.Tensor) else a
                        for a in args]
                self.calls.setdefault(_name, []).append((keep, kw))
                return _orig(*args, **kw)
            self._saved.append((mod, name, orig))
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f'chip_smoke: {e}', file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'False)', file=sys.stderr)
        return 1
    try:
        from softgroup_tpu_torch import entry
        from softgroup_tpu_torch.data.synthetic import (make_room_scene,
                                                        make_scene)
        from softgroup_tpu_torch.evaluation.postprocess import (
            get_instances, to_numpy)
        from softgroup_tpu_torch.model import blocks
        from softgroup_tpu_torch.model import softgroup as sg
        from softgroup_tpu_torch.model.softgroup import Capacities
        from softgroup_tpu_torch.ops import conv_kernel as ck
        from softgroup_tpu_torch.ops import gather_kernel as gk
        from softgroup_tpu_torch.ops import grouping, kernels
        from softgroup_tpu_torch.ops import join_kernel as jk
        from softgroup_tpu_torch.ops import sparse_conv, voxelize
    except ImportError as e:
        print(f'chip_smoke: the port is not importable here: {e}',
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = 'cuda'
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # ---- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    kernels.build_all()
    log(f'[build] {len(kernels.SOURCES)} kernel libraries built in '
        f'{time.perf_counter() - t0:.3f} s (nvcc sm_90a, in parallel)')

    cfg = entry.flagship_cfg()
    caps = entry.bench_capacities()
    net = entry.build_net(cfg, seed=0, device=dev, bf16=True)
    # a random init leaves the 20-way softmax near 1/20 < score_thr 0.2, so
    # grouping and refinement would run on nothing: lift two non-ignored
    # classes (2 and 3) to ~0.29 each through the semantic head's final
    # bias.  Every other flagship setting is kept.
    with torch.no_grad():
        net.semantic_linear.final_bias[2:4] = SEMANTIC_BIAS

    def make_request(seed):
        t = time.perf_counter()
        scene = make_room_scene(np.random.RandomState(seed),
                                n_points=250000, n_instances=12)
        batch = entry.build_batch(scene, cfg, caps, device=dev)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
        return batch, host_ms

    # ---- phase 2: each kernel against its plain version ----------------
    batch, host_ms = make_request(0)
    log(f'[warmup] host batch of a 250k-point room: {host_ms:.3f} ms')
    sites = [(sparse_conv, 'rulebook_conv'), (blocks, 'keyed_conv'),
             (voxelize, 'row_gather'), (grouping, 'row_gather'),
             (sg, 'row_gather'), (grouping, 'cell_neighbor_join')]
    with Recorder(sites) as rec:
        out = entry.infer(net, batch, cfg, caps)
        torch.cuda.synchronize()
    n_prop0 = int(out['n_proposals'])
    log(f'[warmup] test_forward done, n_proposals={n_prop0}')
    if n_prop0 <= 0:
        raise RuntimeError('warm-up request produced no proposals')

    conv_calls = rec.calls['rulebook_conv']
    keyed_calls = rec.calls['keyed_conv']
    gather_calls = rec.calls['row_gather']
    join_calls = rec.calls['cell_neighbor_join']

    def pick(calls, pred, what):
        for args, kw in calls:
            if pred(args, kw):
                return args, kw
        raise RuntimeError(f'no recorded call for {what}')

    v0 = caps.voxels[0]
    cases = []   # (name, kernel key, fn, plain, library, tol, reason, bound)

    def conv_case(label, args, dtype):
        feats, w, rules = args
        feats, w = feats.to(dtype), w.to(dtype)
        hits = int((rules >= 0).sum())
        flops = 2.0 * hits * w.shape[1] * w.shape[2]
        byts = nbytes(feats, w.to(dtype), rules) \
            + rules.shape[1] * w.shape[2] * feats.element_size()
        peak = PEAK_FLOPS[str(dtype).split('.')[-1]]
        bound = max(byts / HBM_BYTES_PER_S, flops / peak) * 1e3
        tol_rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2e-5
        cases.append(dict(
            name=f'K1 rulebook_conv {label}', key='rulebook_conv',
            route='cuda', source='softgroup_tpu_torch/csrc/conv.cu',
            replaces='softgroup_tpu/ops/conv_kernel.py:374',
            fn=lambda: ck.rulebook_conv(feats, w, rules),
            plain=lambda: ck.rulebook_conv_plain(feats, w, rules),
            library=None, tol_rel=tol_rel,
            reason=('f32 sums in another order, one rounding of the output '
                    f'to {dtype}: {tol_rel:g} x max|plain|'),
            bound_ms=bound, bound_by='bytes' if byts / HBM_BYTES_PER_S
            >= flops / peak else 'operations'))

    l0_subm = pick(conv_calls, lambda a, k: a[2].shape == (27, v0)
                   and a[1].shape[1:] == (32, 32), 'L0 subm 32->32')[0]
    conv_case('L0 subm 32->32 bf16', l0_subm, torch.bfloat16)
    conv_case('L0 subm 32->32 f32', l0_subm, torch.float32)
    conv_case('input conv 6->32 bf16', pick(
        conv_calls, lambda a, k: a[1].shape[1] == 6, 'input conv')[0],
        torch.bfloat16)
    conv_case('L5 tail 384->192 bf16', pick(
        conv_calls, lambda a, k: a[1].shape[1:] == (384, 192),
        '384->192')[0], torch.bfloat16)
    conv_case('L6 subm 224->224 bf16', pick(
        conv_calls, lambda a, k: a[1].shape[1:] == (224, 224),
        '224->224')[0], torch.bfloat16)
    conv_case('L0->L1 down 32->64 bf16', pick(
        conv_calls, lambda a, k: a[2].shape[0] == 8
        and a[1].shape[1:] == (32, 64), 'down L0->L1')[0], torch.bfloat16)

    def gather_case(label, args):
        src, idx = args
        byts = nbytes(src, idx) + idx.shape[0] * src[0].numel() \
            * src.element_size()
        idx_l = idx.long().clamp(0, src.shape[0] - 1)
        cases.append(dict(
            name=f'K2 row_gather {label}', key='row_gather', route='cuda',
            source='softgroup_tpu_torch/csrc/gather.cu',
            replaces='softgroup_tpu/ops/gather_kernel.py:52',
            fn=lambda: gk.row_gather(src, idx),
            plain=lambda: gk.row_gather_plain(src, idx),
            library=lambda: torch.index_select(src, 0, idx_l),
            tol_rel=0.0, reason='a copy: exact',
            bound_ms=byts / HBM_BYTES_PER_S * 1e3, bound_by='bytes'))

    gather_case('devoxelize (V0, 32) bf16', pick(
        gather_calls, lambda a, k: a[0].dtype == torch.bfloat16
        and a[0].shape == (v0, 32), 'devoxelize')[0])
    gather_case('grouping entries (P, 4) f32', pick(
        gather_calls, lambda a, k: a[0].dtype == torch.float32
        and a[0].shape[1:] == (4,), 'entry gather')[0])
    gather_case('cell labels (m+1,) int32', pick(
        gather_calls, lambda a, k: a[0].dim() == 1
        and a[0].shape[0] == caps.grouping_cells + 1, 'label gather')[0])

    keys, cen, cc, dims, offs, radius = join_calls[0][0]
    m = keys.shape[0]
    join_bytes = nbytes(keys, cen, cc, dims) + len(offs) * m * 4
    cases.append(dict(
        name=f'K3 cell_neighbor_join m={m}', key='cell_neighbor_join',
        route='cuda', source='softgroup_tpu_torch/csrc/join.cu',
        replaces='softgroup_tpu/ops/join_kernel.py:54',
        fn=lambda: jk.cell_neighbor_join(keys, cen, cc, dims, offs, radius),
        plain=lambda: jk.cell_neighbor_join_plain(keys, cen, cc, dims, offs,
                                                  radius),
        library=None, tol_rel=0.0,
        reason='integer join, gate in the plain order without FMA: exact',
        bound_ms=join_bytes / HBM_BYTES_PER_S * 1e3, bound_by='bytes'))

    def keyed_case(label, args, kw):
        feats, w, out_keys, in_keys, d = args
        strided = kw['strided']
        rules = ck.rules_from_keys(out_keys, in_keys, d, strided)
        hits = int((rules >= 0).sum())
        flops = 2.0 * hits * w.shape[1] * w.shape[2]
        byts = nbytes(feats, w, out_keys, in_keys) \
            + out_keys.shape[0] * w.shape[2] * feats.element_size()
        peak = PEAK_FLOPS[str(feats.dtype).split('.')[-1]]
        cases.append(dict(
            name=f'K4 keyed_conv {label}', key='keyed_conv', route='cuda',
            source='softgroup_tpu_torch/csrc/conv.cu',
            replaces='softgroup_tpu/ops/conv_kernel.py:802',
            fn=lambda: ck.keyed_conv(feats, w, out_keys, in_keys, d,
                                     strided),
            plain=lambda: ck.keyed_conv_plain(feats, w, out_keys, in_keys,
                                              d, strided),
            library=None, tol_rel=2.0 ** -7,
            reason='f32 sums in another order, one bf16 rounding: '
                   '2^-7 x max|plain|',
            bound_ms=max(byts / HBM_BYTES_PER_S, flops / peak) * 1e3,
            bound_by='bytes' if byts / HBM_BYTES_PER_S >= flops / peak
            else 'operations'))

    keyed_case('subm D=20 32->32', *pick(
        keyed_calls, lambda a, k: not k['strided'] and a[4] == 20
        and a[1].shape[1:] == (32, 32), 'keyed subm D=20'))
    keyed_case('down D=10 32->64', *pick(
        keyed_calls, lambda a, k: k['strided'] and a[4] == 10,
        'keyed down D=10'))
    del rec, out

    results = []
    for c in cases:
        got = c['fn']()
        want = c['plain']()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise RuntimeError(f"{c['name']}: {got.shape}/{got.dtype} vs "
                               f"{want.shape}/{want.dtype}")
        err = float((got.double() - want.double()).abs().max()) \
            if got.numel() else 0.0
        scale = float(want.double().abs().max()) if want.numel() else 0.0
        tol = c['tol_rel'] * max(1.0, scale)
        ok = err <= tol
        ms = cuda_ms(c['fn'])
        plain_ms = cuda_ms(c['plain'], reps=3, warm=1)
        lib_ms = cuda_ms(c['library']) if c['library'] else None
        log(f"[kernel] {c['name']}: max_abs_err={err:.6g} tol={tol:.6g} "
            f"({c['reason']}) ms={ms:.6f} plain_ms={plain_ms:.6f} "
            f"library_ms={lib_ms} bound_ms={c['bound_ms']:.6f} "
            f"({c['bound_by']}) [{card}] {'OK' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{c['name']} disagrees with its plain "
                               f"version: {err} > {tol}")
        results.append(dict(
            name=c['name'], key=c['key'], route=c['route'],
            source=c['source'], replaces=c['replaces'], max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=c['bound_ms'],
            bound_by=c['bound_by'], library_ms=lib_ms))
    del cases

    # ---- phase 3: the main path ----------------------------------------
    wrappers = dict(rulebook_conv=ck.rulebook_conv,
                    row_gather=gk.row_gather,
                    cell_neighbor_join=jk.cell_neighbor_join,
                    keyed_conv=ck.keyed_conv)
    for w in wrappers.values():
        w.launches = 0
    per_scan = []
    for i in range(N_REQUESTS):
        seed = 100 + i
        batch, host_ms = make_request(seed)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = entry.infer(net, batch, cfg, caps)
        torch.cuda.synchronize()
        dev_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        outs = to_numpy(out)
        n = int(batch.pyramid.point_valid.sum())
        inst = get_instances(f'room{seed}', outs, n, cfg)
        post_ms = (time.perf_counter() - t) * 1e3
        n_prop = int(outs['n_proposals'])
        sem = outs['semantic_scores']
        if sem.shape != (caps.points, 20) or not np.isfinite(sem[:n]).all():
            raise RuntimeError('semantic scores not finite / wrong shape')
        for k in ('cls_scores', 'iou_scores', 'mask_scores'):
            if not np.isfinite(outs[k]).all():
                raise RuntimeError(f'{k} not finite')
        if n_prop <= 0:
            raise RuntimeError(f'request {seed}: no proposals')
        per_scan.append((host_ms, dev_ms, post_ms))
        log(f'[request] room seed={seed} points={n} host_batch_ms='
            f'{host_ms:.3f} test_forward_ms={dev_ms:.3f} '
            f'get_instances_ms={post_ms:.3f} n_proposals={n_prop} '
            f'instances={len(inst)} [{card}]')
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f'[main-path] launches over {N_REQUESTS} requests: '
        f'{json.dumps(launches)}')
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise RuntimeError(f'kernels never launched on the main path: '
                           f'{missing}')
    dev_ms = sorted(s[1] for s in per_scan)
    host_ms = sorted(s[0] for s in per_scan)
    mid = len(per_scan) // 2
    log(f'[main-path] test_forward ms/scan median={dev_ms[mid]:.3f} '
        f'min={dev_ms[0]:.3f} max={dev_ms[-1]:.3f}; host batch ms/scan '
        f'median={host_ms[mid]:.3f} [{card}]')

    # ---- where the time goes: one more request under the profiler --------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batch, _ = make_request(100)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        entry.infer(net, batch, cfg, caps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # kernels only, no ops
            continue
        us = getattr(ev, 'self_device_time_total', None)
        if us is None:
            us = getattr(ev, 'self_cuda_time_total', 0.0)
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f'[profile] one request: wall {wall_ms:.3f} ms, device busy '
        f'{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f} '
        f'(profiler on) [{card}]')
    for ms_, count, key in rows[:12]:
        log(f'[profile]   {ms_:9.3f} ms  x{count:<5d} {key[:90]}')

    # ---- phase 4: small input, card (f32) vs CPU (plain versions) -------
    small_caps = Capacities(
        points=32768, voxels=(32768, 16384, 8192, 4096, 2048, 1024, 512),
        grouping_points=65536, proposals=64, proposal_entries=65536,
        instances=64, inst_voxels=(16384, 4096), grouping_cells=8192)
    scene = make_scene(np.random.RandomState(7), n_points=20000,
                       n_instances=12)
    outs = {}
    for d in ('cpu', dev):
        small_net = entry.build_net(cfg, seed=1, device=d, bf16=False)
        with torch.no_grad():
            small_net.semantic_linear.final_bias[2:4] = SEMANTIC_BIAS
        b = entry.build_batch(scene, cfg, small_caps, device=d)
        outs[d] = to_numpy(entry.infer(small_net, b, cfg, small_caps))
    a, r = outs[dev], outs['cpu']
    n = 20000
    sem_err = float(np.abs(a['semantic_scores'][:n]
                           - r['semantic_scores'][:n]).max())
    off_err = float(np.abs(a['pt_offsets'][:n] - r['pt_offsets'][:n]).max())

    def sets(o):
        ev = o['entry_valid']
        props = {}
        for s, p in zip(o['entry_seg'][ev], o['entry_pt'][ev]):
            props.setdefault(int(s), set()).add(int(p))
        return list(props.values())

    pa, pr = sets(a), sets(r)
    best = [max((len(x & y) / len(x | y) for y in pa), default=0.0)
            for x in pr]
    miou = float(np.mean(best)) if best else 0.0
    log(f'[small] card vs CPU on a 20k-point scene (f32): semantic max err '
        f'{sem_err:.3g} (tol 1e-3), offset max err {off_err:.3g} (tol 1e-3), '
        f'proposals {len(pa)} vs {len(pr)}, mean best IoU {miou:.6f} '
        f'(tol 0.99: centroid sums may round differently)')
    if sem_err > 1e-3 or off_err > 1e-3 or not pr or miou < 0.99:
        raise RuntimeError('card and CPU disagree on the small input')

    for r_ in results:
        r_['launches'] = launches[r_.pop('key')]
    log(card)
    print(json.dumps({'kernels': results}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
