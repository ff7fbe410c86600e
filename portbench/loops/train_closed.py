"""A trainer in a closed loop over a pool of batches built in set-up.

Set-up: the kernels; the pool (``batches`` x ``rooms_per_batch`` rooms
from the seed, each batch the program's host batch at the configuration's
capacities, pinned); the net, the benchmark's weights from the seed and
the train state of the program's train CLI; then the first
``checked_steps`` steps on batches that all differ, whose losses,
step-1 gradients (Adam's first moment) and changes the reference checks,
and one step on each other batch of the pool.

Window: step ``i`` copies batch ``i mod pool`` to the card
(``non_blocking``) and runs the same train state; it ends in a
synchronise.  ``train_scenes_per_s`` is the rooms of the completed steps
over the window.  A step fails when it raises or its loss is not finite.
With ``--trace 1`` a stretch of ``trace_items`` steps is profiled once,
after a third of the window.  The set-up's objects are frozen out of the
garbage collector for the window (a full collection would scan them all
while the host paces part of every step); the collector's pauses and the
steps' host intervals in the window are logged.
"""

from __future__ import annotations

import gc
import math
import time

from .. import flops, generator, roofline, spec, weights
from ..check import train_numbers
from ..harness import Result, log

TRACE_LEAD = 1 / 3


def _sync(dev):
    import torch
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def run(ctx) -> Result:
    import torch
    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.ops import kernels, sparse_conv
    from softgroup_tpu_torch.tools_impl import train_cli
    from softgroup_tpu_torch.util.config import Config

    dev, conf, tr = ctx.device, ctx.config, ctx.traffic
    cfg = Config(conf['run'])
    caps = train_cli.caps_from_cfg(cfg)
    scale = float(cfg.data.train.voxel_cfg.scale)
    n_cls = cfg.model.semantic_classes
    with ctx.phase('kernel_libraries'):
        if dev.type == 'cuda':
            kernels.build_all()
    with ctx.phase('pool'):
        rooms = generator.train_pool(tr, ctx.seed, n_cls)
        pool = [entry.build_train_batch(r, cfg.model, caps, scale=scale,
                                        device='cpu') for r in rooms]
        if dev.type == 'cuda':
            pool = [b.pin_memory() for b in pool]
    counts = [flops.pyramid_counts(b.pyramid) for b in pool]
    for i, (hits, vox, pts) in enumerate(counts):
        log(f'[work] batch {i}: points {pts}; level voxels {vox} of caps '
            f'{list(caps.voxels)}; valid rulebook hits {hits}')
    with ctx.phase('net'):
        net = train_cli.build_net(cfg, device=dev)
    with ctx.phase('weights'):
        shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        w0 = weights.make(shapes, ctx.seed, dev, conf.get('lift'))
        net.load_state_dict(w0)
    with ctx.phase('train_state'):
        state, _ = train_cli.build_train_state(
            net, cfg, caps, conf['steps_per_epoch'])
    named = [(n, p) for n, p in net.named_parameters() if p.requires_grad]
    beta1 = state.optimizer.param_groups[0]['betas'][0]
    gen = torch.Generator().manual_seed(ctx.seed % 2 ** 63)

    def step(i):
        with ctx.span('h2d'):
            batch = pool[i % len(pool)].to(dev, non_blocking=True)
        with ctx.span('step'):
            return state.step(batch, generator=gen)['loss']

    checked = tr['checked_steps']
    with ctx.phase('warm_up'):
        prog = dict(losses=[])
        for i in range(checked):
            prog['losses'].append(float(step(i)))
            if i == 0:
                # an optimizer that kept no moment got no gradient: zero
                prog['grad'] = {
                    n: (state.optimizer.state.get(p, {}).get(
                        'exp_avg', torch.zeros_like(p)) / (1 - beta1)).cpu()
                    for n, p in named}
        prog['delta'] = {n: (p.detach() - w0[n]).cpu() for n, p in named}
        w0 = {k: v.cpu() for k, v in w0.items()}
        for i in range(checked, max(checked, len(pool))):
            step(i)
        _sync(dev)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - ctx.t_start
    log('[setup] ' + ' '.join(f'{k} {v:.3f} s' for k, v in
                               ctx.setup.items()) + f'; total {setup_s:.3f} s')

    losses, attempted, failed = [], 0, 0
    i = max(checked, len(pool))
    trace = None
    pauses = GcPauses()
    marks = []
    t0 = time.perf_counter()
    if ctx.trace:
        lead = t0 + ctx.seconds * TRACE_LEAD
        while time.perf_counter() < lead:
            losses.append(step(i))
            i, attempted = i + 1, attempted + 1
        _sync(dev)
        lead_s, lead_steps = time.perf_counter() - t0, i
        sites = {'k1': (sparse_conv, 'rulebook_conv', roofline.k1_call),
                 'k5': (sparse_conv, 'rulebook_conv_dw', roofline.k5_call)}
        first = i
        with ctx.tracer.stretch(sites) as trace:
            for _ in range(tr['trace_items']):
                losses.append(step(i))
                i, attempted = i + 1, attempted + 1
        # model FLOPs over the untraced lead: the profiler slows the host
        trace.counts = dict(steps=i - first, lead_s=lead_s, lead_flops=sum(
            flops.backbone_flops(shapes, *counts[j % len(pool)])
            for j in range(max(checked, len(pool)), lead_steps)))
    else:
        deadline = t0 + ctx.seconds
        while time.perf_counter() < deadline:
            attempted += 1
            try:
                losses.append(step(i))
            except Exception as e:      # a failed step counts, the loop runs on
                failed += 1
                log(f'[fail] step {i}: {e}')
            i += 1
            marks.append(time.perf_counter())
    _sync(dev)
    window = time.perf_counter() - t0
    pauses.close()
    gc.unfreeze()
    gaps = sorted(b - a for a, b in zip([t0] + marks, marks))
    if gaps:
        log(f'[host] {pauses.count} collections, {pauses.seconds:.4f} s; '
            f'step intervals median {gaps[len(gaps) // 2] * 1e3:.2f} ms, '
            f'max {gaps[-1] * 1e3:.2f} ms')
    if losses:
        failed += int((~torch.isfinite(torch.stack(losses))).sum())
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda'
            else 0)
    completed = attempted - failed
    e2e = dict(train_scenes_per_s=completed * tr['rooms_per_batch'] / window)
    log(f'[window] {window:.3f} s: {attempted} steps, {failed} failed, '
        f'{e2e["train_scenes_per_s"]:.4f} scenes/s; peak {peak} bytes')
    if trace is not None:
        log(f'[trace] stretch {trace.window_s:.4f} s, busy '
            f'{trace.busy_s:.4f} s, {len(trace.launches)} launches, '
            f'{trace.counts}; lost call ranges {trace.lost}')

    del state, net, pool, losses, step
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    numbers = check_training(ctx, conf, cfg, rooms[:checked], w0, prog,
                             [n for n, _ in named])
    return Result(attempted, failed, e2e, setup_s, peak, numbers, trace)


class GcPauses:
    """The garbage collector's collections, and the seconds they took,
    from construction to ``close``."""

    def __init__(self):
        self.count, self.seconds, self._t = 0, 0.0, 0.0
        gc.callbacks.append(self._on)

    def _on(self, phase, info):
        if phase == 'start':
            self._t = time.perf_counter()
        else:
            self.count += 1
            self.seconds += time.perf_counter() - self._t

    def close(self):
        gc.callbacks.remove(self._on)


def lr_at(cfg, steps_per_epoch: int, k: int) -> float:
    """The recipe's learning rate at update ``k``: constant until
    ``step_epoch``, then a cosine to 0 at ``epochs``."""
    t = max(k / steps_per_epoch - cfg.step_epoch, 0.0)
    span = max(cfg.epochs - cfg.step_epoch, 1)
    return cfg.optimizer.lr * 0.5 * (1.0 + math.cos(math.pi * t / span))


def reference_steps(conf, cfg, rooms, w0: dict, trainable: list, dev,
                    precision: str = 'f32') -> dict:
    """The reference's Adam steps on ``rooms`` (a batch a step) from the
    weights ``w0``, in ``precision``."""
    ref = spec.reference(conf['reference'])
    m, opt = cfg.model, cfg.optimizer
    scale = float(cfg.data.train.voxel_cfg.scale)
    scenes = [ref.scene(r, scale, m.num_blocks, m.get('with_coords', True),
                        m.ignore_label, dev) for r in rooms]
    lrs = [lr_at(cfg, conf['steps_per_epoch'], k) for k in range(len(rooms))]
    with ref.NoTF32():
        return ref.adam_steps({k: v.to(dev) for k, v in w0.items()},
                              trainable, scenes, lrs, opt.get('b1', 0.9),
                              opt.get('b2', 0.999), opt.get('eps', 1e-8),
                              ref.Precision(precision))


def check_training(ctx, conf, cfg, rooms, w0, prog, trainable) -> dict:
    """The reference's first steps on the same rooms from the same
    weights, and the numbers of ``check.train_numbers``."""
    t = time.perf_counter()
    out = reference_steps(conf, cfg, rooms, w0, trainable, ctx.device)
    numbers, notes = train_numbers(prog, out)
    log(f'[reference] {time.perf_counter() - t:.3f} s; losses program '
        f'{prog["losses"]} reference {out["losses"]}; worst-leaf gradient '
        f'gap {numbers["grad_gap"]:.6g}; {notes}')
    return numbers


def control_reading(bench, wl, seed: int) -> dict:
    """The control: the reference's checked steps computed in float8 put
    in the program's place, against the reference in float32, from the
    same weights on the same rooms."""
    import torch
    from softgroup_tpu_torch.tools_impl import train_cli
    from softgroup_tpu_torch.util.config import Config
    dev = torch.device('cuda', 0)
    conf, tr = spec.config(wl['config']), spec.traffic(wl['traffic'])
    cfg = Config(conf['run'])
    net = train_cli.build_net(cfg, device='cpu')
    fixed = set(cfg.model.get('fixed_modules', []))
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    trainable = [n for n, _ in net.named_parameters()
                 if n.split('.')[0] not in fixed]
    rooms = generator.train_pool(tr, seed, cfg.model.semantic_classes)
    rooms = rooms[:tr['checked_steps']]
    w0 = weights.make(shapes, seed, dev, conf.get('lift'))
    out = {p: reference_steps(conf, cfg, rooms, w0, trainable, dev, p)
           for p in ('fp8', 'f32')}
    return train_numbers(out['fp8'], out['f32'])[0]
