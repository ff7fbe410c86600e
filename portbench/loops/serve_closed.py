"""One client in a closed loop over a pool of rooms whose host batches
were built in set-up.

Set-up: the kernels; the net with the benchmark's weights from the seed
(batch norms on their running statistics); the pool: ``pool`` rooms from
the seed, written as prepared scans under a temporary directory, read
back through the configuration's test dataset (its x4-split collate) and
built into host batches on the card by the program's inference runner;
then one forward of each room.

Window: room ``i`` of the pool (``i mod pool``) is served as the runner
serves it: ``InferenceRunner.forward`` then the copy of every output to
the host (``evaluation.postprocess.to_numpy``).  A room counts once its
outputs are on the host; its latency runs from its dispatch to then.  A
room fails when it raises or its scores are not finite.
``scans_per_s`` is the rooms served over the window, ``scan_p90_ms`` the
90th percentile of their latencies.  The outputs of ``sample`` rooms,
drawn from the seed, are kept and judged by the reference after the
window.
"""

from __future__ import annotations

import gc
import os
import statistics
import tempfile
import time

import numpy as np

from .. import flops, generator, roofline, spec, weights
from ..check import serve_numbers
from ..harness import Result, log

TRACE_LEAD = 1 / 3
# the first served rooms the sample is drawn from
SAMPLE_FROM = 24


def _sync(dev):
    import torch
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def scans(rooms: list, data_cfg) -> list:
    """The rooms as the test dataset collates them: written as prepared
    scans (labels as float64) and read back."""
    import torch
    from softgroup_tpu_torch.data import build_dataset
    with tempfile.TemporaryDirectory() as root:
        for j, (xyz, rgb, sem, inst) in enumerate(rooms):
            torch.save((xyz, rgb, sem.astype(np.float64),
                        inst.astype(np.float64)),
                       os.path.join(root, f'Area_5_room{j:03d}'
                                    '_inst_nostuff.pth'))
        dcfg = data_cfg.copy()
        dcfg.data_root = root
        ds = build_dataset(dcfg)
        return [ds.collate_fn([ds[j]]) for j in range(len(ds))]


def run(ctx) -> Result:
    import torch
    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.evaluation.postprocess import to_numpy
    from softgroup_tpu_torch.ops import kernels, sparse_conv
    from softgroup_tpu_torch.util.config import Config

    dev, conf, tr = ctx.device, ctx.config, ctx.traffic
    cfg = Config(conf['run'])
    with ctx.phase('kernel_libraries'):
        if dev.type == 'cuda':
            kernels.build_all()
    with ctx.phase('net'):
        net = entry.build_net(cfg.model, device=dev,
                              bf16=bool(cfg.tpu.get('bf16', True)))
    with ctx.phase('weights'):
        shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        w0 = weights.make(shapes, ctx.seed, dev, conf.get('lift'))
        net.load_state_dict(w0)
        w0 = {k: v.cpu() for k, v in w0.items()}
        runner = entry.build_s3dis_runner(net, cfg, device=dev)
    with ctx.phase('pool'):
        rooms = generator.serve_pool(tr, ctx.seed, cfg.model.semantic_classes)
        pool = [runner.build_batch(d) for d in scans(rooms, cfg.data.test)]
    for j, (batch, caps) in enumerate(pool):
        lv = batch.pyramid.levels
        log(f'[work] room {j}: points {int(batch.pyramid.point_valid.sum())}'
            f' of cap {caps.points}; level voxels '
            f'{[int(v.vox_valid.sum()) for v in lv]} of caps '
            f'{list(caps.voxels)}; valid rulebook hits '
            f'{[int((v.subm_rules >= 0).sum()) for v in lv]}')

    # the backbone's and point heads' forward FLOPs of each room (the
    # refinement head's keyed convs resolve their hits inside K4: not
    # counted)
    room_flops = [flops.backbone_flops(
        shapes, *flops.pyramid_counts(b.pyramid), train=False)
        for b, _ in pool]

    def serve(i):
        batch, caps = pool[i % len(pool)]
        with ctx.span('forward'):
            out = runner.forward(batch, caps)
            floats = [v for v in out.values() if v.is_floating_point()]
            out['finite'] = torch.stack([torch.isfinite(v).all()
                                         for v in floats]).all()
        with ctx.span('copy_out'):
            return to_numpy(out)

    with ctx.phase('warm_up'):
        for j in range(len(pool)):
            host = serve(j)
            log(f'[work] room {j}: n_proposals {int(host["n_proposals"])}, '
                f'valid entries {int(host["entry_valid"].sum())}')
        _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    log('[setup] ' + ' '.join(f'{k} {v:.3f} s' for k, v in
                               ctx.setup.items()) + f'; total {setup_s:.3f} s')

    rng = np.random.default_rng([ctx.seed % 2 ** 64, 1])
    want = set(rng.choice(SAMPLE_FROM, size=tr['sample'],
                          replace=False).tolist())
    kept, lat, last = {}, [], [None]
    attempted = failed = 0
    i = 0
    trace = None
    t0 = time.perf_counter()

    def one():
        nonlocal attempted, failed, i
        attempted += 1
        t = time.perf_counter()
        try:
            host = serve(i)
            if not bool(host['finite']):
                failed += 1
            lat.append(time.perf_counter() - t)
            if i in want:
                kept[i] = host
            last[0] = (i, host)
        except Exception as e:      # a failed room counts, the loop runs on
            failed += 1
            log(f'[fail] room {i}: {e}')
        i += 1

    if ctx.trace:
        lead = t0 + ctx.seconds * TRACE_LEAD
        while time.perf_counter() < lead:
            one()
        lead_s, lead_rooms = time.perf_counter() - t0, i
        sites = {'k1': (sparse_conv, 'rulebook_conv', roofline.k1_call)}
        first = i
        with ctx.tracer.stretch(sites) as trace:
            for _ in range(tr['trace_items']):
                one()
        # model FLOPs over the untraced lead: the profiler slows the host
        trace.counts = dict(rooms=i - first, lead_s=lead_s, lead_flops=sum(
            room_flops[j % len(pool)] for j in range(lead_rooms)))
    else:
        deadline = t0 + ctx.seconds
        while time.perf_counter() < deadline:
            one()
    _sync(dev)
    window = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda'
            else 0)
    completed = attempted - failed
    p90 = (statistics.quantiles(lat, n=10)[8] if len(lat) >= 2
           else float('nan'))
    e2e = dict(scans_per_s=completed / window, scan_p90_ms=p90 * 1e3)
    beyond = sum(x > p90 for x in lat)
    log(f'[window] {window:.3f} s: {attempted} rooms, {failed} failed, '
        f'{e2e["scans_per_s"]:.4f} scans/s, p90 {e2e["scan_p90_ms"]:.3f} '
        f'ms ({beyond} rooms beyond it), median '
        f'{statistics.median(lat) * 1e3 if lat else float("nan"):.3f} ms; '
        f'peak {peak} bytes')

    if last[0] is not None:       # the last room served is judged too
        kept[last[0][0]] = last[0][1]
    del pool, runner, net, serve, one, last
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    numbers = check_serving(ctx, conf, cfg, rooms, w0, kept)
    return Result(attempted, failed, e2e, setup_s, peak, numbers, trace)


def check_serving(ctx, conf, cfg, rooms, w0, kept: dict,
                  precision: str = 'f32') -> dict:
    """The reference on each kept room, the worst of each number."""
    import torch
    ref = spec.reference(conf['reference'])
    dev = ctx.device
    t = time.perf_counter()
    P = {k: v.to(dev) for k, v in w0.items()}
    base = dict(proposals=cfg.tpu.caps.proposals,
                proposal_entries=cfg.tpu.caps.proposal_entries,
                inst_voxels=list(cfg.tpu.caps.inst_voxels))
    scale = float(cfg.data.test.voxel_cfg.scale)
    worst = {}
    if not kept:
        return dict(served_checked=float('inf'))
    with ref.NoTF32(), torch.no_grad():
        for i, host in sorted(kept.items()):
            room = rooms[i % len(rooms)]
            nums = serve_numbers(ref, P, room, host, scale, cfg.model, base,
                                 ref.Precision(precision), dev)
            log(f'[reference] served room {i}: {nums}')
            for k, v in nums.items():
                worst[k] = max(worst.get(k, 0.0), v)
    log(f'[reference] {time.perf_counter() - t:.3f} s over {len(kept)} '
        f'rooms')
    return worst


def control_reading(bench, wl, seed: int) -> dict:
    """The control, put in the program's place and judged by the
    reference in float32 on the pool's rooms: the reference with its
    products in float8 (the program's are bf16) and its grouping
    coordinates in bfloat16 (the program's are float32)."""
    import torch
    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.util.config import Config
    dev = torch.device('cuda', 0)
    conf, tr = spec.config(wl['config']), spec.traffic(wl['traffic'])
    cfg = Config(conf['run'])
    ref = spec.reference(conf['reference'])
    shapes = {k: tuple(v.shape) for k, v in entry.build_net(
        cfg.model, device='cpu').state_dict().items()}
    P = weights.make(shapes, seed, dev, conf.get('lift'))
    rooms = generator.serve_pool(tr, seed, cfg.model.semantic_classes)
    base = dict(proposals=cfg.tpu.caps.proposals,
                proposal_entries=cfg.tpu.caps.proposal_entries,
                inst_voxels=list(cfg.tpu.caps.inst_voxels))
    scale = float(cfg.data.test.voxel_cfg.scale)
    low = ref.Precision('fp8')
    worst = {}
    with ref.NoTF32(), torch.no_grad():
        for room in rooms:
            sem, off, feat, coords, order = ref.backbone(
                P, room, scale, cfg.model.num_blocks, dev, low)
            sem, off, feat, coords = (sem[order], off[order], feat[order],
                                      coords[order])
            caps = ref.capacities(len(order), base)
            e_pt, e_seg, e_valid, n_prop = ref.grouping(
                sem, off, coords, cfg.model, caps, torch.bfloat16)
            cls, iou, mask = ref.refine(P, feat, coords, e_pt, e_seg,
                                        e_valid, n_prop, caps, cfg.model,
                                        low)
            full = torch.zeros((len(e_valid), mask.shape[1]), device=dev)
            full[e_valid] = mask
            host = dict(semantic_scores=sem, pt_offsets=off, entry_pt=e_pt,
                        entry_seg=e_seg, entry_valid=e_valid,
                        n_proposals=n_prop, cls_scores=cls, iou_scores=iou,
                        mask_scores=full)
            nums = serve_numbers(ref, P, room, host, scale, cfg.model, base,
                                 ref.Precision('f32'), dev)
            for k, v in nums.items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst
