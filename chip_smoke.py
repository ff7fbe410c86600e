#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines and its seconds; any failure exits
non-zero):
  1. the card's name and power limit; build the CUDA kernels (one nvcc per
     source, in parallel) and print the build time;
  2. a warm-up request of the flagship model, one of the SoftGroup++ model
     through the runner and a warm-up all-params train step record the
     arguments each kernel gets on the three main paths; each
     kernel is then held against its plain PyTorch version on those inputs
     (max-abs error, tolerance, the bound of the card) and timed: the
     kernel's and the library call's device time (``device_ms``,
     ``library_device_ms``: the profiler's device time over 20 calls, the
     time kernels are ranked on; ``partial_trace=True`` where the trace
     stayed short of 20 x the kernels of one call after three tries), CUDA
     events around 10 back-to-back calls
     of the kernel, the plain version and the library call (``ms``,
     ``plain_ms``, ``library_ms``: host gaps included), and the wrapper's
     host time a call (``host_us``);
  3. the serving path: >= 3 requests (host batch -> test_forward on the
     card -> get_instances) of 250k-point rooms at full flagship width, with
     every launch counter set to 0 just before and read just after, then
     one request under the profiler;
  3b. the SoftGroup++ serving path: 3 requests of 250k-point rooms through
     the inference runner (``entry.build_runner(...).run_scene``: native
     host batch at bucketed capacities -> test_forward_plus -> instances on
     voxels expanded to points) of the SoftGroup++ ScanNet model, counters
     set to 0 just before and read just after, with each request's stage
     times and per-class pyramid levels; the host batch with the native
     and the numpy builders, and each builder alone, in turns; K3's
     census at the request's cell capacity;
     one test_forward_plus under the profiler; and a small scene through
     the runner on the card (f32) against the CPU;
  4. the training path: the flagship ScanNet train step (the yaml's model
     section, batch 4 x 250k-point rooms, bf16) in both modes of the recipe
     (frozen backbone, then all params), 1 warm-up and 3 timed steps each,
     counters set to 0 just before the timed steps and read just after,
     then one all-params step under the profiler;
  5. small inputs through the card (f32) against the same port on the CPU
     (plain PyTorch versions of every kernel): a request, then a train step
     held gradient leaf by gradient leaf against control runs
     (``small_train_check``).
The line before the last is one JSON object of per-kernel numbers; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

N_REQUESTS = 3
TRAIN_STEPS = 3
TRAIN_SEED0 = 200
SEMANTIC_BIAS = 2.5
# a train-step gradient leaf's card-vs-CPU gap over the same leaf's gap
# with the plain versions on the card
GRAD_CTRL_FACTOR = 4.0
# a ReLU input that may change sides between the card and the CPU: within
# rounding of 0 (inputs are O(1) after batch norm; the two agree to ~1e-6)
KINK_BOUND = 1e-4
FROZEN = 'frozen backbone'
ALL = 'all params'


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def profile(fn, label: str, card: str) -> None:
    """Wall time, device busy time, idle share and the top 12 kernels of
    one run of ``fn`` under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from softgroup_tpu_torch.time_kernels import kernel_rows
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = sorted(kernel_rows(prof), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f'[profile] {label}: wall {wall_ms:.3f} ms, device busy '
        f'{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f} '
        f'(profiler on) [{card}]')
    for ms_, count, key in rows[:12]:
        log(f'[profile]   {ms_:9.3f} ms  x{count:<5d} {key[:90]}')
    # the conv kernels' totals, every instantiation (the slab sums apart)
    fams = {'K1 rulebook_conv_tc<RuleSlab>': ('rulebook_conv_tc', 'RuleSlab'),
            'K4 rulebook_conv_tc<KeyedSlab>': ('rulebook_conv_tc',
                                               'KeyedSlab'),
            'K5 conv_dw_tc': ('conv_dw_tc',),
            'split slab sums (sum_partials)': ('sum_partials',),
            'K6 segment_sum_chunks': ('segment_sum_chunks',),
            'K6 segment_sum_spans': ('segment_sum_spans',),
            'K7 rules_join': ('rules_join',),
            'K3 cell_join': ('cell_join',)}
    log('[profile]   by kernel: ' + ', '.join(
        f'{name} {sum(r[0] for r in rows if all(w in r[2] for w in ws)):.3f}'
        f' ms in {sum(r[1] for r in rows if all(w in r[2] for w in ws))}'
        for name, ws in fams.items()))


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
        from softgroup_tpu_torch.ops import rulebook, sparse_conv
        from softgroup_tpu_torch.data.synthetic import collate_scenes
        from softgroup_tpu_torch.time_kernels import (
            Recorder, bound, cell_join_bound, cuda_ms, device_reading,
            dw_bound, host_us, k4_args, k5_args, k6_trained_fill,
            k7_trained_fill, nbytes, pick, plus_args, reading_text,
            rules_bound, segsum_bound)
    except ImportError as e:
        print(f'chip_smoke: the port is not importable here: {e}',
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = 'cuda'
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        log(f'[phase] {name}: {now - t_phase:.3f} s')
        t_phase = now

    # ---- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    kernels.build_all()
    log(f'[build] {len(kernels.SOURCES)} kernel libraries built in '
        f'{time.perf_counter() - t0:.3f} s (nvcc sm_90a, in parallel)')

    cfg = entry.flagship_cfg()
    caps = entry.bench_capacities()
    tcfg = entry.train_cfg()
    tcaps = entry.train_capacities()

    def lift(net):
        # a random init leaves the 20-way softmax near 1/20 < score_thr
        # 0.2, so grouping and refinement would run on nothing: lift two
        # non-ignored classes (2 and 3) to ~0.29 each through the semantic
        # head's final bias.  Every other flagship setting is kept.
        with torch.no_grad():
            net.semantic_linear.final_bias[2:4] = SEMANTIC_BIAS
        return net

    net = lift(entry.build_net(cfg, seed=0, device=dev, bf16=True))

    def make_request(seed):
        t = time.perf_counter()
        scene = make_room_scene(np.random.RandomState(seed),
                                n_points=250000, n_instances=12)
        batch = entry.build_batch(scene, cfg, caps, device=dev)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
        return batch, host_ms

    pcfg = entry.plus_cfg()
    pnet = lift(entry.build_net(pcfg, seed=0, device=dev, bf16=True))
    runner = entry.build_runner(pnet, pcfg)

    def plus_data(seed, n_points=250000, room=True):
        """One collated scan for the runner: a room of ``n_points`` from
        ``seed`` (``room=False``: a ``make_scene`` scene)."""
        rng = np.random.RandomState(seed)
        scene = (make_room_scene(rng, n_points=n_points, n_instances=12)
                 if room else make_scene(rng, n_points=n_points,
                                         n_instances=12))
        data = collate_scenes([scene], scale=50.0)
        data['scan_ids'] = [f'room{seed}']
        return data

    def make_train_batch(i):
        """Batch ``i``: 4 rooms of 250k points from seeds 200 + 4i ...;
        returns (batch, host ms)."""
        t = time.perf_counter()
        scenes = [make_room_scene(np.random.RandomState(
            TRAIN_SEED0 + 4 * i + j), n_points=250000, n_instances=12)
            for j in range(4)]
        batch = entry.build_train_batch(scenes, tcfg, tcaps, device=dev)
        torch.cuda.synchronize()
        return batch, (time.perf_counter() - t) * 1e3

    def train_state(frozen):
        return entry.build_train_state(
            lift(entry.build_net(tcfg, seed=0, device=dev, bf16=True)), tcfg,
            tcaps, frozen)

    # ---- phase 2: each kernel against its plain version ----------------
    batch, host_ms = make_request(0)
    log(f'[warmup] host batch of a 250k-point room: {host_ms:.3f} ms')
    sites = [(sparse_conv, 'rulebook_conv'), (blocks, 'keyed_conv'),
             (gk, 'row_gather'), (grouping, 'row_gather'),
             (sg, 'row_gather'), (grouping, 'cell_neighbor_join')]
    with Recorder(sites) as rec:
        out = entry.infer(net, batch, cfg, caps)
        torch.cuda.synchronize()
    n_prop0 = int(out['n_proposals'])
    log(f'[warmup] test_forward done, n_proposals={n_prop0}')
    if n_prop0 <= 0:
        raise RuntimeError('warm-up request produced no proposals')

    with Recorder(sites) as prec:
        pstats = {}
        runner.run_scene(plus_data(0), stats=pstats)
    log(f'[warmup] SoftGroup++ request done: caps={pstats["caps"]}, '
        f'n_proposals={pstats["n_proposals"]}')
    if pstats['n_proposals'] <= 0:
        raise RuntimeError('warm-up SoftGroup++ request produced no '
                           'proposals')

    train_batches = [make_train_batch(i) for i in range(TRAIN_STEPS + 1)]
    log(f'[warmup] {len(train_batches)} host batches of 4 x 250k points: '
        f'{[round(b[1], 3) for b in train_batches]} ms')
    state = train_state(())
    with Recorder([(sparse_conv, 'rulebook_conv_dw'),
                   (gk, 'sorted_segment_sum'),
                   (rulebook, 'sorted_key_rules_join'),
                   (grouping, 'cell_neighbor_join')]) as trec:
        logs = state.step(train_batches[0][0],
                          generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
    log(f'[warmup] all-params train step done: loss='
        f'{float(logs["loss"]):.6f} num_pos={float(logs["num_pos"]):.0f} '
        f'num_neg={float(logs["num_neg"]):.0f}')
    del state

    conv_calls = rec.calls['rulebook_conv']
    keyed_calls = rec.calls['keyed_conv']
    gather_calls = rec.calls['row_gather']
    join_calls = rec.calls['cell_neighbor_join']
    dw_calls = trec.calls['rulebook_conv_dw']
    segsum_calls = trec.calls['sorted_segment_sum']
    rules_calls = trec.calls['sorted_key_rules_join']
    train_join_calls = trec.calls['cell_neighbor_join']

    v0 = caps.voxels[0]
    cases = []

    def conv_case(label, args, dtype, path='serving'):
        feats, w, rules = args
        feats, w = feats.to(dtype), w.to(dtype)
        hits = int((rules >= 0).sum())
        flops = 2.0 * hits * w.shape[1] * w.shape[2]
        byts = nbytes(feats, w, rules) \
            + rules.shape[1] * w.shape[2] * feats.element_size()
        tol_rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2e-5
        cases.append(dict(
            name=f'K1 rulebook_conv {label}', key='rulebook_conv',
            path=path, route='cuda', source='softgroup_tpu_torch/csrc/conv.cu',
            replaces='softgroup_tpu/ops/conv_kernel.py:374',
            fn=lambda: ck.rulebook_conv(feats, w, rules),
            plain=lambda: ck.rulebook_conv_plain(feats, w, rules),
            library=None, tol_rel=tol_rel,
            reason=('f32 sums in another order, one rounding of the output '
                    f'to {dtype}: {tol_rel:g} x max|plain|'),
            bound=bound(byts, flops, dtype)))

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

    def gather_case(label, args, path='serving'):
        src, idx = args
        byts = nbytes(src, idx) + idx.shape[0] * src[0].numel() \
            * src.element_size()
        idx_l = idx.long().clamp(0, src.shape[0] - 1)
        cases.append(dict(
            name=f'K2 row_gather {label}', key='row_gather', path=path,
            route='cuda',
            source='softgroup_tpu_torch/csrc/gather.cu',
            replaces='softgroup_tpu/ops/gather_kernel.py:52',
            fn=lambda: gk.row_gather(src, idx),
            plain=lambda: gk.row_gather_plain(src, idx),
            library=lambda: torch.index_select(src, 0, idx_l),
            tol_rel=0.0, reason='a copy: exact',
            bound=bound(byts, 0.0, src.dtype if src.is_floating_point()
                        else torch.float32)))

    gather_case('devoxelize (V0, 32) bf16', pick(
        gather_calls, lambda a, k: a[0].dtype == torch.bfloat16
        and a[0].shape == (v0, 32), 'devoxelize')[0])
    gather_case('grouping entries (P, 4) f32', pick(
        gather_calls, lambda a, k: a[0].dtype == torch.float32
        and a[0].shape[1:] == (4,), 'entry gather')[0])
    gather_case('cell labels (m+1,) int32', pick(
        gather_calls, lambda a, k: a[0].dim() == 1
        and a[0].shape[0] == caps.grouping_cells + 1, 'label gather')[0])

    def join_case(args, path):
        keys, cen, cc, dims, offs, radius = args
        cases.append(dict(
            name=f'K3 cell_neighbor_join m={keys.shape[0]}',
            key='cell_neighbor_join', path=path, route='cuda',
            source='softgroup_tpu_torch/csrc/join.cu',
            replaces='softgroup_tpu/ops/join_kernel.py:54',
            fn=lambda: jk.cell_neighbor_join(*args),
            plain=lambda: jk.cell_neighbor_join_plain(*args),
            library=None, tol_rel=0.0,
            reason='integer join, gate in the plain order without FMA: '
                   'exact',
            bound=cell_join_bound(keys, cen, cc, dims, len(offs))))

    # the request's grouping (m = grouping_cells of the serving caps) and
    # the all-params step's (m = 131072)
    join_case(join_calls[0][0], 'serving')
    join_case(train_join_calls[0][0], 'train_all')
    # the SoftGroup++ request's (m = grouping_cells of its bucketed caps)
    plus_join = prec.calls['cell_neighbor_join'][0][0]
    join_case(plus_join, 'serving_plus')

    def keyed_case(label, args, kw, path='serving'):
        feats, w, out_keys, in_keys, d = args
        strided = kw['strided']
        rules = ck.rules_from_keys(out_keys, in_keys, d, strided)
        hits = int((rules >= 0).sum())
        flops = 2.0 * hits * w.shape[1] * w.shape[2]
        byts = nbytes(feats, w, out_keys, in_keys) \
            + out_keys.shape[0] * w.shape[2] * feats.element_size()
        cases.append(dict(
            name=f'K4 keyed_conv {label}', key='keyed_conv', path=path,
            route='cuda',
            source='softgroup_tpu_torch/csrc/conv.cu',
            replaces='softgroup_tpu/ops/conv_kernel.py:802',
            fn=lambda: ck.keyed_conv(feats, w, out_keys, in_keys, d,
                                     strided),
            plain=lambda: ck.keyed_conv_plain(feats, w, out_keys, in_keys,
                                              d, strided),
            library=None, tol_rel=2.0 ** -7,
            reason='f32 sums in another order, one bf16 rounding: '
                   '2^-7 x max|plain|',
            bound=bound(byts, flops, feats.dtype)))

    for label, (a, kw) in k4_args(keyed_calls).items():
        keyed_case(label[3:], a, kw)

    # the SoftGroup++ request's K1, K2 and K4 calls at its bucketed caps
    for label, (a, kw) in plus_args(prec.calls, pstats['caps'],
                                    pcfg.semantic_classes + 3).items():
        fam, label = label.split(' ', 1)
        if fam == 'K1':
            conv_case(label, a, torch.bfloat16, 'serving_plus')
        elif fam == 'K2':
            gather_case(label, a, 'serving_plus')
        else:
            keyed_case(label, a, kw, 'serving_plus')

    def dw_case(label, args, dtype):
        feats, g, rules = args
        feats, g = feats.to(dtype), g.to(dtype)
        cases.append(dict(
            name=f'K5 rulebook_conv_dw {label}', key='rulebook_conv_dw',
            route='cuda', source='softgroup_tpu_torch/csrc/conv.cu',
            replaces='softgroup_tpu/ops/conv_kernel.py:1170',
            fn=lambda: ck.rulebook_conv_dw(feats, g, rules),
            plain=lambda: ck.rulebook_conv_dw_plain(feats, g, rules),
            library=None, tol_rel=5e-4,
            reason=('f32 sums of up to 8.5e5 exact products in another '
                    'order (32-row MMA steps and slab sums vs one cuBLAS '
                    'f32 GEMM per tap): ~eps*sqrt(steps) ~ 3e-6 of a sum, '
                    'x10 for the worst entry, x10 margin: 5e-4 x '
                    'max|plain|'),
            bound=dw_bound(feats, g, rules)))

    for label, args in k5_args(dw_calls, tcaps).items():
        dw_case(f'{label} bf16', args, torch.bfloat16)
        if label.startswith('L0 subm'):
            dw_case(f'{label} f32', args, torch.float32)

    def segsum_check(values, seg, s):
        """K6 held per element to the plain f32 sum, with no floor on the
        scale, so a kernel that writes zeros or loses a run fails whatever
        the size of the gradients: f32 output within 1e-5 x max|plain|;
        bf16 output within half a bf16 ulp of each f32 sum (2^-8 x |plain|,
        one rounding) + 1e-5 x max|plain| (the sum's order).  Returns the
        max abs error against the plain version in out's dtype, the worst
        error over its bound, and the bound as text."""
        def check(got, want):
            ref = gk.sorted_segment_sum_plain(values, seg, s).double()
            scale = float(ref.abs().max()) if ref.numel() else 0.0
            if scale == 0.0:   # zeros against zeros hold nothing
                return 0.0, float('inf'), 'max|plain| = 0: nothing compared'
            err = float((got.double() - want.double()).abs().max()) \
                if got.numel() else 0.0
            diff = (got.double() - ref).abs()
            if got.dtype == torch.float32:
                bound = torch.full_like(ref, 1e-5 * scale)
                text = f'{1e-5 * scale:.6g}'
            else:
                bound = 2.0 ** -8 * ref.abs() + 1e-5 * scale
                text = f'2^-8 x |plain| + {1e-5 * scale:.6g} each element'
            worst = float((diff / bound.clamp_min(1e-30)).max()) \
                if got.numel() else 0.0
            return err, worst, text
        return check

    def segsum_case(label, args, kw):
        values, seg, s = args
        ok = (seg >= 0) & (seg < s)
        seg_l, vals_f = seg[ok].long(), values[ok].float()
        out_dtype = kw.get('out_dtype', torch.float32)
        cases.append(dict(
            name=f'K6 sorted_segment_sum {label}',
            key='sorted_segment_sum', route='cuda',
            source='softgroup_tpu_torch/csrc/gather.cu',
            replaces='softgroup_tpu/ops/gather_kernel.py:149',
            fn=lambda: gk.sorted_segment_sum(values, seg, s, **kw),
            plain=lambda: gk.sorted_segment_sum_plain(values, seg, s, **kw),
            library=lambda: torch.zeros(
                (s, values.shape[1]), dtype=torch.float32,
                device=values.device).index_add_(0, seg_l, vals_f),
            check=segsum_check(values, seg, s),
            reason=('f32 sums in another order than the plain '
                    "index_add_'s atomics: 1e-5 x max|plain|"
                    if out_dtype == torch.float32 else
                    'f32 sums in another order, each rounded once to bf16: '
                    'per element, 2^-8 x |plain f32 sum| + 1e-5 x '
                    'max|plain|'),
            bound=segsum_bound(values, seg, s, out_dtype)))

    def segsum_pick(width, what):
        return pick(segsum_calls, lambda a, k: a[0].shape[1] == width, what)

    def seeded(args, seed):
        """The recorded call with seeded N(0, 1) values in the recorded
        dtype and shape, on the recorded seg: with random weights the step
        has few positive proposals, so the recorded cotangents of the two
        proposal gathers are zero or nearly so."""
        values, seg, s = args
        g = torch.Generator(device=values.device).manual_seed(seed)
        return (torch.randn(values.shape, generator=g, device=values.device)
                .to(values.dtype), seg, s)

    args, kw = segsum_pick(32, 'devoxelize backward')
    segsum_case(f'devoxelize backward ({tcaps.points}, 32) bf16', args, kw)
    args, kw = segsum_pick(35, 'proposal-gather backward')
    segsum_case('proposal-gather backward (S, 35) f32, seeded values',
                seeded(args, 35), kw)
    args, kw = segsum_pick(19, 'mask-gather backward')
    segsum_case(f'mask-gather backward (S, 19) '
                f'{str(args[0].dtype).split(".")[-1]}, seeded values',
                seeded(args, 19), kw)
    # a trained model's fill: runs of 1-16 rows, no dustbin (the mask
    # gather's backward at a trained model's proposal counts)
    segsum_case('trained fill (524288, 19) bf16', k6_trained_fill(dev),
                {'out_dtype': torch.bfloat16})

    def rules_case(label, args):
        cases.append(dict(
            name=f'K7 sorted_key_rules_join {label}',
            key='sorted_key_rules_join', route='cuda',
            source='softgroup_tpu_torch/csrc/join.cu',
            replaces='softgroup_tpu/ops/join_kernel.py:225',
            fn=lambda: jk.sorted_key_rules_join(*args),
            plain=lambda: jk.sorted_key_rules_join_plain(*args),
            library=None, tol_rel=0.0, reason='integer join: exact',
            bound=rules_bound(args[0], args[1], args[2], len(args[3]))))

    for m_ in tcaps.inst_voxels:
        rules_case(f'm={m_}', pick(rules_calls, lambda a, k: a[0].shape[0]
                                   == m_, f'K7 m={m_}')[0])
    # a trained model's fill: every row a voxel of dense 20^3 grids
    rules_case('trained fill m=131072', k7_trained_fill(dev))
    del rec, trec, prec, out

    results = []
    for c in cases:
        got = c['fn']()
        want = c['plain']()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise RuntimeError(f"{c['name']}: {got.shape}/{got.dtype} vs "
                               f"{want.shape}/{want.dtype}")
        if 'check' in c:
            err, worst, tol = c['check'](got, want)
            ok = worst <= 1.0
            tol += f' (worst error / bound {worst:.3g})'
        else:
            err = float((got.double() - want.double()).abs().max()) \
                if got.numel() else 0.0
            scale = float(want.double().abs().max()) if want.numel() \
                else 0.0
            tol = c['tol_rel'] * max(1.0, scale)
            ok = err <= tol
            tol = f'{tol:.6g}'
        if not ok:
            log(f"[kernel] {c['name']}: max_abs_err={err:.6g} "
                f"tol={tol} ({c['reason']}) [{card}] FAIL")
            raise RuntimeError(f"{c['name']} disagrees with its plain "
                               f"version: {err} beyond {tol}")
        ms = cuda_ms(c['fn'])
        reading = device_reading(c['fn'])
        wrap_us = host_us(c['fn'])
        plain_ms = cuda_ms(c['plain'], reps=3, warm=1)
        lib = c['library']
        lib_ms = cuda_ms(lib) if lib else None
        lib_dev = device_reading(lib) if lib else None
        bound_ms, bound_by = c['bound']
        log(f"[kernel] {c['name']}: max_abs_err={err:.6g} tol={tol} "
            f"({c['reason']}) device_ms={reading_text(reading)} ms={ms:.6f} "
            f"host_us={wrap_us:.3f} plain_ms={plain_ms:.6f} "
            f"library_device_ms="
            f"{reading_text(lib_dev) if lib_dev else None} "
            f"library_ms={lib_ms} bound_ms={bound_ms:.6f} ({bound_by}) "
            f"[{card}] OK")
        key = c['key']
        results.append(dict(
            name=c['name'], key=key, route=c['route'],
            # the path the kernel was ported for, whose launches count
            path=c.get('path', 'train_all' if key in (
                'rulebook_conv_dw', 'sorted_segment_sum',
                'sorted_key_rules_join') else 'serving'),
            source=c['source'], replaces=c['replaces'], max_abs_err=err,
            ms=ms, device_ms=reading[0], host_us=wrap_us, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
            library_device_ms=lib_dev[0] if lib_dev else None,
            partial_trace=reading[1] or bool(lib_dev and lib_dev[1])))
    del cases
    torch.cuda.empty_cache()
    phase_done('kernels vs plain')

    # ---- phase 3: the serving path -------------------------------------
    wrappers = dict(rulebook_conv=ck.rulebook_conv,
                    row_gather=gk.row_gather,
                    cell_neighbor_join=jk.cell_neighbor_join,
                    keyed_conv=ck.keyed_conv,
                    rulebook_conv_dw=ck.rulebook_conv_dw,
                    sorted_segment_sum=gk.sorted_segment_sum,
                    sorted_key_rules_join=jk.sorted_key_rules_join)

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        return {k: w.launches for k, w in wrappers.items()}

    reset_counts()
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
    serve_counts = read_counts()
    log(f'[main-path] serving: launches over {N_REQUESTS} requests: '
        f'{json.dumps(serve_counts)}')
    missing = [k for k in ('rulebook_conv', 'row_gather',
                           'cell_neighbor_join', 'keyed_conv')
               if serve_counts[k] <= 0]
    if missing:
        raise RuntimeError(f'kernels never launched on the serving path: '
                           f'{missing}')
    dev_ms = sorted(s[1] for s in per_scan)
    host_ms = sorted(s[0] for s in per_scan)
    mid = len(per_scan) // 2
    log(f'[main-path] test_forward ms/scan median={dev_ms[mid]:.3f} '
        f'min={dev_ms[0]:.3f} max={dev_ms[-1]:.3f}; host batch ms/scan '
        f'median={host_ms[mid]:.3f} [{card}]')
    batch, _ = make_request(100)
    profile(lambda: entry.infer(net, batch, cfg, caps), 'one request', card)
    del batch, out
    phase_done('serving path')

    # ---- phase 3b: the SoftGroup++ serving path ------------------------
    plus_counts = plus_phase(runner, plus_data, lift, pcfg, plus_join,
                             reset_counts, read_counts, card, dev)
    phase_done('SoftGroup++ serving path')

    # ---- phase 4: the training path ------------------------------------
    train_counts = {}
    for mode in (FROZEN, ALL):
        frozen = tuple(tcfg.fixed_modules) if mode == FROZEN else ()
        state = train_state(frozen)
        named = dict(state.net.named_parameters())
        state.step(train_batches[0][0],
                   generator=torch.Generator().manual_seed(0))
        before = {k: p.detach().clone() for k, p in named.items()}
        torch.cuda.synchronize()
        reset_counts()
        step_ms = []
        for i in range(1, TRAIN_STEPS + 1):
            batch, bhost_ms = train_batches[i]
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            logs = state.step(batch,
                              generator=torch.Generator().manual_seed(i))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            logs = {k: float(v) for k, v in logs.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f'[train] {mode} step {i}: host_batch_ms={bhost_ms:.3f} '
                f'step_ms={step_ms[-1]:.3f} '
                + ' '.join(f'{k}={v:.6g}' for k, v in logs.items())
                + f' peak_mem_gib={peak:.3f} [{card}]')
            bad = [k for k, v in logs.items() if not np.isfinite(v)]
            if bad:
                raise RuntimeError(f'{mode}: non-finite {bad}')
            if logs['num_pos'] + logs['num_neg'] <= 0:
                raise RuntimeError(f'{mode} step {i}: no proposals')
        counts = read_counts()
        train_counts[mode] = counts
        log(f'[main-path] training ({mode}): launches over {TRAIN_STEPS} '
            f'steps: {json.dumps(counts)}')
        need = ['rulebook_conv', 'row_gather', 'cell_neighbor_join',
                'rulebook_conv_dw', 'sorted_segment_sum',
                'sorted_key_rules_join']
        missing = [k for k in need if counts[k] <= 0]
        if missing:
            raise RuntimeError(f'kernels never launched on the training '
                               f'path ({mode}): {missing}')
        for k, p in named.items():
            top = k.split('.')[0]
            if top in frozen:
                if p.grad is not None or not torch.equal(p, before[k]):
                    raise RuntimeError(f'{mode}: frozen {k} changed')
                continue
            if not torch.isfinite(p.grad).all():
                raise RuntimeError(f'{mode}: non-finite gradient of {k}')
        for m_ in ('tiny_unet', 'cls_linear') + (
                ('input_conv', 'unet') if mode == ALL else ()):
            if not any(bool(p.grad.abs().max() > 0) for k, p in named.items()
                       if k.startswith(m_ + '.')):
                raise RuntimeError(f'{mode}: {m_} has no gradient')
        moved = sum(not torch.equal(p, before[k]) for k, p in named.items()
                    if k.split('.')[0] not in frozen)
        if moved == 0:
            raise RuntimeError(f'{mode}: no parameter moved')
        log(f'[main-path] training ({mode}): step ms median='
            f'{statistics.median(step_ms):.3f} min={min(step_ms):.3f} '
            f'max={max(step_ms):.3f}; {moved} trainable leaves moved, '
            f'{len(frozen)} frozen modules unchanged [{card}]')
        if mode == ALL:
            profile(lambda: state.step(
                train_batches[1][0], generator=torch.Generator().manual_seed(
                    9)), 'one all-params train step', card)
        del state, named, before
        torch.cuda.empty_cache()
    del train_batches
    phase_done('training path')

    # ---- phase 5: small inputs, card (f32) vs CPU (plain versions) ------
    small_caps = Capacities(
        points=32768, voxels=(32768, 16384, 8192, 4096, 2048, 1024, 512),
        grouping_points=65536, proposals=64, proposal_entries=65536,
        instances=64, inst_voxels=(16384, 4096), grouping_cells=8192)
    scene = make_scene(np.random.RandomState(7), n_points=20000,
                       n_instances=12)
    outs = {}
    for d in ('cpu', dev):
        small_net = lift(entry.build_net(cfg, seed=1, device=d, bf16=False))
        b = entry.build_batch(scene, cfg, small_caps, device=d)
        outs[d] = to_numpy(entry.infer(small_net, b, cfg, small_caps))
    a, r = outs[dev], outs['cpu']
    n = 20000
    sem_err = float(np.abs(a['semantic_scores'][:n]
                           - r['semantic_scores'][:n]).max())
    off_err = float(np.abs(a['pt_offsets'][:n] - r['pt_offsets'][:n]).max())
    miou, n_a, n_r = best_iou(a, r)
    log(f'[small] card vs CPU on a 20k-point scene (f32): semantic max err '
        f'{sem_err:.3g} (tol 1e-3), offset max err {off_err:.3g} (tol 1e-3), '
        f'proposals {n_a} vs {n_r}, mean best IoU {miou:.6f} '
        f'(tol 0.99: centroid sums may round differently)')
    if sem_err > 1e-3 or off_err > 1e-3 or not n_r or miou < 0.99:
        raise RuntimeError('card and CPU disagree on the small input')
    small_train_check(entry, sg, blocks, small_caps, scene, lift, dev)
    phase_done('small card vs CPU')

    for r_ in results:
        key = r_.pop('key')
        by_path = {'serving': serve_counts[key],
                   'serving_plus': plus_counts[key],
                   'train_frozen': train_counts[FROZEN][key],
                   'train_all': train_counts[ALL][key]}
        r_['launches'] = by_path[r_.pop('path')]
        r_['launches_by_path'] = by_path
    log(card)
    print(json.dumps({'kernels': results}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


class HeadLevels:
    """Keeps a reference to the level-0 semantic head's output of the
    latest forward (no work inside the timed forward); ``last()`` then
    gives the per-class active rows and pyramid levels that grouping took
    from it."""

    def __init__(self, net, gcfg):
        self.net, self.gcfg, self.seen = net, gcfg, None

    def __enter__(self):
        def keep(module, args, out):
            self.seen = (out, args[1])
        self.hook = self.net.semantic_linear.register_forward_hook(keep)
        return self

    def __exit__(self, *exc):
        self.hook.remove()

    def last(self):
        from softgroup_tpu_torch.model import softgroup as sg
        counts = sg.class_active_counts(*self.seen, self.gcfg)
        levels = sg.pyramid_levels(counts, self.gcfg)
        return counts.tolist(), [int(v) for v in levels.tolist()]


def plus_phase(runner, plus_data, lift, pcfg, plus_join, reset_counts,
               read_counts, card, dev) -> dict:
    """Phase 3b (see the module docstring); returns the launch counts of
    the three requests."""
    import numpy as np
    import torch

    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.evaluation.postprocess import to_numpy
    from softgroup_tpu_torch.model.softgroup import Capacities
    from softgroup_tpu_torch.time_kernels import k3_census
    reset_counts()
    rows = []
    with HeadLevels(runner.net, pcfg.grouping_cfg) as lv:
        for i in range(N_REQUESTS):
            seed = 100 + i
            data = plus_data(seed)
            n = len(data['coords'])
            torch.cuda.synchronize()
            st = {}
            ret = runner.run_scene(data, stats=st)
            counts, levels = lv.last()
            caps = st['caps']
            inst = ret['pred_instances']
            if ret['semantic_preds'].shape != (n,) or not np.isfinite(
                    ret['offset_preds']).all():
                raise RuntimeError(f'++ request {seed}: bad point outputs')
            if st['n_proposals'] <= 0 or not all(
                    np.isfinite(x['conf']) for x in inst):
                raise RuntimeError(f'++ request {seed}: no proposals or a '
                                   f'non-finite confidence')
            rows.append(st)
            lifted = ', '.join(f'class {c}: {counts[c]} active voxels, '
                               f'level {levels[c]}' for c in (2, 3))
            log(f'[plus] room seed={seed} points={n} caps: points='
                f'{caps.points} voxels={list(caps.voxels)} grouping_points='
                f'{caps.grouping_points} proposal_entries='
                f'{caps.proposal_entries} grouping_cells='
                f'{caps.grouping_cells}; host_batch_ms={st["host_batch_ms"]:.3f}'
                f' (native) test_forward_plus_ms={st["forward_ms"]:.3f} '
                f'get_instances_ms={st["postprocess_ms"]:.3f} n_proposals='
                f'{st["n_proposals"]} instances={len(inst)}; levels by class '
                f'{levels} ({lifted}) [{card}]')
            if min(counts[2], counts[3]) <= 1e5:
                log(f'[plus]   classes 2-3 stay at or below 1e5 active '
                    f'voxels: level 2 is not reached in this request')
    plus_counts = read_counts()
    log(f'[main-path] SoftGroup++ serving: launches over {N_REQUESTS} '
        f'requests: {json.dumps(plus_counts)}')
    missing = [k for k in ('rulebook_conv', 'row_gather',
                           'cell_neighbor_join', 'keyed_conv')
               if plus_counts[k] <= 0]
    if missing:
        raise RuntimeError(f'kernels never launched on the SoftGroup++ '
                           f'serving path: {missing}')
    for key, what in (('forward_ms', 'test_forward_plus'),
                      ('host_batch_ms', 'host batch'),
                      ('postprocess_ms', 'get_instances')):
        v = sorted(r[key] for r in rows)
        log(f'[main-path] SoftGroup++ {what} ms/scan median='
            f'{v[len(v) // 2]:.3f} min={v[0]:.3f} max={v[-1]:.3f} [{card}]')

    # the same room's host batch, native and numpy builders, in turns
    data = plus_data(100)
    times = {True: [], False: []}
    for native in (True, False, True, False):
        t = time.perf_counter()
        runner.build_batch(data, native=native)
        torch.cuda.synchronize()
        times[native].append((time.perf_counter() - t) * 1e3)
    log(f'[host] SoftGroup++ host batch of room seed=100 (bucketed caps, '
        f'tensors on the card): native builders '
        f'{", ".join(f"{v:.3f}" for v in times[True])} ms, numpy builders '
        f'{", ".join(f"{v:.3f}" for v in times[False])} ms (in turns)')
    host_builders(data)

    k3_census([('SoftGroup++ request', plus_join,
                plus_counts['cell_neighbor_join'])], 'chip_smoke', card,
              [None])
    batch, caps = runner.build_batch(data)
    profile(lambda: runner.forward(batch, caps),
            'one SoftGroup++ request (test_forward_plus)', card)
    del batch

    # a small scene through the runner: card (f32) vs CPU (plain versions),
    # levels 3 taken (thresholds cut to the scene's size)
    small_caps = Capacities(
        points=32768, voxels=(32768, 16384, 8192, 4096, 2048, 1024, 512),
        grouping_points=65536, proposals=64, proposal_entries=65536,
        instances=64, inst_voxels=(16384, 4096), grouping_cells=8192)
    scfg = pcfg.copy()
    scfg.grouping_cfg.pyramid_thresholds = [2000, 8000]
    data = plus_data(7, n_points=20000, room=False)
    outs, rets, lvls = {}, {}, {}
    for d in ('cpu', dev):
        small = entry.build_runner(
            lift(entry.build_net(scfg, seed=1, device=d, bf16=False)), scfg,
            small_caps, device=d)

        def keep(batch, caps, _f=small.forward, _d=d):
            out = _f(batch, caps)
            outs[_d] = to_numpy(out)
            return out
        small.forward = keep
        with HeadLevels(small.net, scfg.grouping_cfg) as lv:
            rets[d] = small.run_scene(data)
        lvls[d] = lv.last()[1]
    a, r = outs[dev], outs['cpu']
    n = len(data['coords'])
    sem_err = float(np.abs(a['semantic_scores'][:n]
                           - r['semantic_scores'][:n]).max())
    off_err = float(np.abs(a['pt_offsets'][:n] - r['pt_offsets'][:n]).max())
    p_iou, p_a, p_r = best_iou(a, r)
    i_iou, i_a, i_r = instance_iou(rets[dev]['pred_instances'],
                                   rets['cpu']['pred_instances'])
    log(f'[plus-small] card vs CPU, runner on a 20k-point scene (f32, '
        f'levels by class {lvls[dev]} on the card, {lvls["cpu"]} on the '
        f'CPU): semantic max err {sem_err:.3g} (tol 1e-3), offset max err '
        f'{off_err:.3g} (tol 1e-3), proposals (voxel sets) {p_a} vs {p_r}, '
        f'mean best IoU {p_iou:.6f} (tol 0.99), instances {i_a} vs {i_r}, '
        f'mean best IoU with one of its class {i_iou:.6f} (tol 0.99)')
    if (sem_err > 1e-3 or off_err > 1e-3 or not p_r or p_iou < 0.99
            or not i_r or i_iou < 0.99 or 3 not in lvls['cpu']
            or lvls[dev] != lvls['cpu']):
        raise RuntimeError('card and CPU disagree on the small SoftGroup++ '
                           'request')
    return plus_counts


def host_builders(data: dict) -> None:
    """Each host geometry builder alone on the scan's level 0, native and
    numpy in turns (three each): where the two host batches part."""
    from softgroup_tpu_torch.ops import native as nat
    from softgroup_tpu_torch.ops.rulebook import (build_downsample_np,
                                                  build_subm_rules_np)
    from softgroup_tpu_torch.ops.voxelize import voxelize_np
    coords, dims = data['coords'], data['spatial_shape']
    vox = voxelize_np(coords)[0]
    stages = {
        'voxelize': (lambda: nat.voxelize_native(coords),
                     lambda: voxelize_np(coords)),
        'subm rules L0': (lambda: nat.subm_rules_native(vox, dims),
                          lambda: build_subm_rules_np(vox, dims)),
        'downsample L0': (lambda: nat.downsample_native(vox),
                          lambda: build_downsample_np(vox))}
    for name, fns in stages.items():
        times = ([], [])
        for which in (0, 1) * 3:
            t = time.perf_counter()
            fns[which]()
            times[which].append((time.perf_counter() - t) * 1e3)
        log(f'[host]   {name} ({len(vox)} voxels): native '
            f'{", ".join(f"{v:.3f}" for v in times[0])} ms, numpy '
            f'{", ".join(f"{v:.3f}" for v in times[1])} ms (in turns)')


def instance_iou(a: list, r: list) -> tuple[float, int, int]:
    """Mean over ``r``'s instances of the best mask IoU with one of
    ``a``'s of the same class; (mean, len(a), len(r))."""
    import numpy as np

    from softgroup_tpu_torch.util.rle import rle_decode
    masks = [(x['label_id'], rle_decode(x['pred_mask']).astype(bool))
             for x in a]
    best = []
    for x in r:
        mx = rle_decode(x['pred_mask']).astype(bool)
        best.append(max((float((mx & my).sum() / (mx | my).sum())
                         for lab, my in masks if lab == x['label_id']),
                        default=0.0))
    return (float(np.mean(best)) if best else 0.0), len(a), len(r)


def best_iou(a: dict, r: dict) -> tuple[float, int, int]:
    """Mean over ``r``'s proposals (point sets) of the best IoU with one of
    ``a``'s; (mean, len(a's), len(r's))."""
    import numpy as np

    def sets(o):
        ev = o['entry_valid']
        props = {}
        for s, p in zip(o['entry_seg'][ev], o['entry_pt'][ev]):
            props.setdefault(int(s), set()).add(int(p))
        return list(props.values())

    pa, pr = sets(a), sets(r)
    best = [max((len(x & y) / len(x | y) for y in pa), default=0.0)
            for x in pr]
    return (float(np.mean(best)) if best else 0.0), len(pa), len(pr)


class PlainVersions:
    """Swaps every kernel wrapper, at its call sites, for its plain PyTorch
    version (a control run on the card)."""

    def __enter__(self):
        from softgroup_tpu_torch.model import softgroup as sg
        from softgroup_tpu_torch.ops import conv_kernel as ck
        from softgroup_tpu_torch.ops import gather_kernel as gk
        from softgroup_tpu_torch.ops import grouping, rulebook, sparse_conv
        from softgroup_tpu_torch.ops import join_kernel as jk
        swaps = [(sparse_conv, 'rulebook_conv', ck.rulebook_conv_plain),
                 (sparse_conv, 'rulebook_conv_dw', ck.rulebook_conv_dw_plain),
                 (gk, 'sorted_segment_sum', gk.sorted_segment_sum_plain),
                 (gk, 'row_gather', gk.row_gather_plain),
                 (grouping, 'row_gather', gk.row_gather_plain),
                 (sg, 'row_gather', gk.row_gather_plain),
                 (rulebook, 'sorted_key_rules_join',
                  jk.sorted_key_rules_join_plain),
                 (grouping, 'cell_neighbor_join',
                  jk.cell_neighbor_join_plain)]
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
        for m, n, f in swaps:
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


class SkewedK5:
    """Scales K5's result by 1 + SKEW at its call site: a negative control
    that the small train check must reject."""
    SKEW = 1e-4

    def __enter__(self):
        from softgroup_tpu_torch.ops import sparse_conv
        self.orig = orig = sparse_conv.rulebook_conv_dw

        def skewed(*args, **kw):
            return orig(*args, **kw) * (1 + self.SKEW)
        sparse_conv.rulebook_conv_dw = skewed
        return self

    def __exit__(self, *exc):
        from softgroup_tpu_torch.ops import sparse_conv
        sparse_conv.rulebook_conv_dw = self.orig


class AlignedReLU:
    """Stands in for ``torch.relu`` during one train step.  In the
    reference run it keeps every input.  In another run it puts each input
    on the reference's side of 0 wherever the two straddle it (a
    pre-activation within rounding of 0, whose ReLU decision f32 sums in
    another order may flip), moving the value by at most the straddle and
    leaving its gradient path intact, and counts those flips."""

    def __init__(self, ref: list | None = None):
        self.ref, self.seen, self.flips, self.worst = ref, [], 0, 0.0

    def __enter__(self):
        import torch
        self.orig = torch.relu
        torch.relu = self
        return self

    def __exit__(self, *exc):
        import torch
        torch.relu = self.orig

    def __call__(self, x):
        if self.ref is None:
            self.seen.append(x.detach().cpu())
            return self.orig(x)
        r = self.ref[len(self.seen)].to(x.device)
        self.seen.append(None)
        if r.shape != x.shape:
            raise RuntimeError(f'ReLU {len(self.seen)}: shape {tuple(x.shape)}'
                               f' vs the reference\'s {tuple(r.shape)}')
        flip = (x > 0) != (r > 0)
        if flip.any():
            self.flips += int(flip.sum())
            self.worst = max(self.worst, float(
                x.detach().abs().maximum(r.abs())[flip].max()))
            x = x + ((r - x) * flip).detach()
        return self.orig(x)


def small_train_check(entry, sg, blocks, small_caps, scene, lift,
                      dev) -> None:
    """One all-params f32 train step of the flagship training config on a
    20k-point scene, from the same weights and the same (r1, r2), on the
    CPU (plain versions) and on the card.  The offset head is zeroed, so
    the grouping runs on the exact coordinates and every run forms the same
    proposals.

    A ReLU input within rounding of 0 may land on the other side of 0 when
    f32 sums run in another order, and the flip moves the gradient by a
    whole row's contribution (percents of a leaf's max).  Every run but the
    CPU's therefore takes the CPU's side of 0 at each ReLU (AlignedReLU); a
    flip whose input is more than KINK_BOUND from 0 fails the check.  Two
    runs without the alignment (the card, and the CPU with its input one
    ulp up) show what it removes.

    Each gradient leaf is then held on its own: its card-vs-CPU gap may be
    at most GRAD_CTRL_FACTOR times the larger of the same leaf's gaps in
    three controls, plus 1e-5 of the leaf's max (f32 sums of a
    well-conditioned leaf in another order).  The controls: the card with
    every kernel swapped for its plain version (the card's own rounding),
    and the CPU with the network's input one ulp up and one ulp down (how
    far a change of the input within its rounding moves the leaf).  A run
    with K5's result 1e-4 too large must fail that test."""
    import contextlib
    import dataclasses

    import numpy as np
    import torch
    # halve the coordinates and move the instances 1 m apart: dense,
    # separated blobs that the cell grouping (radius 0.04) turns into one
    # proposal each even with random weights, so there are positives
    xyz, rgb, sem, inst = scene
    xyz = (xyz * 0.5 + np.where(inst[:, None] >= 0, inst[:, None], 0)
           * np.array([1.0, 0.0, 0.0])).astype(np.float32)
    scene = (xyz, rgb, sem, inst)
    tcfg = entry.train_cfg()
    rand = torch.tensor([[0.25, 0.5, 0.75], [0.6, 0.3, 0.9]])
    up, down, again = 'one ulp up', 'one ulp down', 'card again'
    plain, skewed = 'card, plain versions', 'card, K5 skewed'
    raw_card, raw_up = 'card, not aligned', 'one ulp up, not aligned'
    none = contextlib.nullcontext
    # (run, device, context, input moved toward, ReLUs aligned)
    runs = (('cpu', 'cpu', none, None, False), ('card', dev, none, None, True),
            (again, dev, none, None, True),
            (plain, dev, PlainVersions, None, True),
            (up, 'cpu', none, float('inf'), True),
            (down, 'cpu', none, float('-inf'), True),
            (raw_card, dev, none, None, False),
            (raw_up, 'cpu', none, float('inf'), False),
            (skewed, dev, SkewedK5, None, True))
    res, bn_rows, kinks = {}, {}, {}
    for run, d, ctx, shift, aligned in runs:
        net = lift(entry.build_net(tcfg, seed=1, device=d, bf16=False))
        with torch.no_grad():
            net.offset_linear.final_kernel.zero_()
            net.offset_linear.final_bias.zero_()
        state = entry.build_train_state(net, tcfg, small_caps)
        batch = entry.build_train_batch([scene], tcfg, small_caps, device=d)
        if shift is not None:
            batch = dataclasses.replace(batch, vox_in=torch.nextafter(
                batch.vox_in, torch.tensor(shift)))
        # the rows each batch norm normalises over (its valid voxels)
        hooks = [m.register_forward_hook(
            lambda m, a, o, n=n: bn_rows.__setitem__(n, int(a[1].sum())))
            for n, m in net.named_modules()
            if isinstance(m, blocks.MaskedBatchNorm)]
        relu = (AlignedReLU(res['cpu']['relu_in']) if aligned
                else AlignedReLU() if run == 'cpu' else none())
        props = []
        orig = sg.forward_grouping

        def grouping(*args, **kw):
            props.append(orig(*args, **kw))
            return props[-1]
        sg.forward_grouping = grouping
        try:
            with ctx(), relu:
                logs = state.step(batch, rand=rand)
        finally:
            sg.forward_grouping = orig
            for h in hooks:
                h.remove()
        res[run] = dict(
            logs={k: float(v) for k, v in logs.items()},
            grads={k: p.grad.cpu().double()
                   for k, p in net.named_parameters()},
            params={k: p.detach().cpu().double()
                    for k, p in net.named_parameters()},
            props={k: v.cpu().numpy() for k, v in props[0]._asdict().items()},
            relu_in=getattr(relu, 'seen', None))
        if aligned:
            kinks[run] = (relu.flips, relu.worst)
    c, g = res['cpu'], res['card']
    adam_eps = state.optimizer.defaults['eps']

    def gap(run, k, ref=c):
        return float((res[run]['grads'][k] - ref['grads'][k]).abs().max())

    def rows_of(leaf):
        # the batch norm of the leaf's own module, else of its nearest
        # enclosing one
        parts = leaf.split('.')[:-1]
        while parts:
            pre = '.'.join(parts)
            near = [n for n in bn_rows if n == pre or n.startswith(pre + '.')]
            if near:
                return bn_rows[min(near, key=len)]
            parts.pop()
        return -1

    def ratio(err, tol):
        return err / tol if tol else (float('inf') if err else 0.0)

    tols, leaves, param_err, det = {}, [], 0.0, 0.0
    for k, gc in c['grads'].items():
        s = float(gc.abs().max())
        tols[k] = tol = (GRAD_CTRL_FACTOR * max(gap(r, k) for r in (
            plain, up, down)) + 1e-5 * s)
        leaves.append((ratio(gap('card', k), tol), k, s))
        det = max(det, gap(again, k, g) / max(s, 1e-30))
        # Adam's first step moves an entry by lr * g / (|g| + eps): where
        # |g| > 10 tol and > 100 eps, the two runs' steps differ by at most
        # lr * (eps / |g|) * (gap / |g|) <= 4e-6 (lr 0.004)
        sure = (gc.abs() > 10 * tol) & (gc.abs() > 100 * adam_eps)
        if sure.any():
            dp = (g['params'][k] - c['params'][k]).abs()
            param_err = max(param_err, float(dp[sure].max()))
    leaves.sort(reverse=True)

    def failing(run):
        return sorted(((ratio(gap(run, k), tols[k]), k) for k in tols
                       if gap(run, k) > tols[k]), reverse=True)

    loss_err = max(abs(g['logs'][k] - v) / max(abs(v), 1e-12)
                   for k, v in c['logs'].items())
    miou, n_a, n_r = best_iou(g['props'], c['props'])
    log(f'[small-train] one all-params f32 step on a 20k-point scene; ReLU '
        f'inputs put on the CPU\'s side of 0 (flips, max |input| at a flip; '
        f'bound {KINK_BOUND:g}): ' + ', '.join(
            f'{r} {n} ({w:.3g})' for r, (n, w) in kinks.items()))
    raw = failing(raw_card)
    if raw:
        r_, k = raw[0]
        s = float(c['grads'][k].abs().max())
        log(f'[small-train] without the alignment the card would fail '
            f'{len(raw)} leaves; worst {k} (gap/tol {r_:.3g}): gap over the '
            f'leaf max: card {gap(raw_card, k) / s:.4g}, CPU with the input '
            f'one ulp up {gap(raw_up, k) / s:.4g}')
    log(f'[small-train] {len(leaves)} gradient leaves, each held to its '
        f'card-vs-CPU gap <= {GRAD_CTRL_FACTOR:g} x max(its gaps with the '
        f'plain versions on the card and with the input one ulp up / down '
        f'on the CPU) + 1e-5 x its max; card vs card again: max gap / leaf '
        f'max {det:.3g}; the 8 leaves with the largest gap / tol (gaps to '
        f'the CPU over the leaf max; rows = rows of its batch norm):')
    for r_, k, s in leaves[:8]:
        log(f'[small-train]   {k}: gap/tol {r_:.3g}, max {s:.4g}, card '
            f'{gap("card", k) / s:.4g}, plain on card {gap(plain, k) / s:.4g}'
            f', {up} {gap(up, k) / s:.4g}, {down} {gap(down, k) / s:.4g}, '
            f'rows {rows_of(k)}')
    caught = failing(skewed)
    log(f'[small-train] negative control, K5\'s result x (1 + '
        f'{SkewedK5.SKEW:g}): {len(caught)} leaves fail (must be > 0)')
    log(f'[small-train] card vs CPU: max rel loss err {loss_err:.3g} (tol '
        f'1e-4), max updated-param err {param_err:.3g} (tol 1e-5 where '
        f'|CPU grad| > 10 x the leaf\'s tol and > 100 x Adam\'s eps), '
        f'proposals {n_a} vs {n_r}, mean best IoU {miou:.6f} (tol 0.99), '
        f'num_pos={c["logs"]["num_pos"]:.0f} '
        f'mask_loss={c["logs"]["mask_loss"]:.6g}')
    if max(w for _, w in kinks.values()) > KINK_BOUND:
        raise RuntimeError('small train step: a ReLU input beyond '
                           f'{KINK_BOUND:g} of 0 changed sides')
    bad = failing('card')
    if bad:
        raise RuntimeError(f'small train step: gradients of '
                           f'{[k for _, k in bad]} differ beyond their '
                           f'tolerance')
    if not caught:
        raise RuntimeError('small train step: the check let a skewed K5 '
                           'through')
    if not (loss_err <= 1e-4 and param_err <= 1e-5 and n_r
            and miou >= 0.99):
        raise RuntimeError('card and CPU disagree on the small train step')
    if c['logs']['num_pos'] <= 0 or c['logs']['mask_loss'] <= 0:
        raise RuntimeError('small train step: no positive proposal / mask '
                           'loss')

if __name__ == '__main__':
    sys.exit(main())
