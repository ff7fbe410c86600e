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
  3c. the S3DIS serving path: two synthetic 1M-point S3DIS rooms written
     as Area_5 scans, run through ``run_eval`` (the dataset's x4_split
     protocol, the runner, ``test_forward`` with pair-key grouping on int64
     cell keys, ``get_instances`` with the sem2ins masks, then the instance
     and point-wise evaluators) of the S3DIS yaml's model at full width,
     counters set to 0 just before and read just after, with each room's
     stage times and the metrics; K3's census on the request's int64 keys;
     one request's forward under the profiler; and a small x4_split room
     through the runner on the card (f32) against the CPU;
  3d. the SemanticKITTI panoptic path: two ray-cast ~120k-point sweeps
     (seeds 400-401) written as sequence 08 scans beside the dataset's
     metadata, the KITTI yaml's net at full width (Cin 1, with_coords off,
     int64 cell keys) with seeded weights written as a ``.pth`` in the
     reference's layout, then the test CLI (``tools_impl.test_cli.main``:
     the weight import, the runner, ``panoptic_fusion``, ``PanopticEval``,
     the ``.label`` writer), counters set to 0 just before and read just
     after, with each scan's caps, cells, stage times and counts, the
     metrics and the ``.label`` files checked; K3's int64 census; one
     request's forward under the profiler; and a small sweep through the
     runner on the card (f32) against the CPU;
  3e. the SoftGroup++ S3DIS serving path: phase 3c's two rooms through
     ``run_eval`` of ``softgroup++_s3dis_fold5.yaml`` (no x4_split,
     lvl_fusion, scene-pyramid grouping on int64 cell keys) at full width,
     counters set to 0 just before and read just after, with each room's
     caps, level-0 voxels, per-class pyramid levels, grouping cells filled
     and dropped, stage times and counts, the metrics and ``run_eval``'s
     wall; K3's int64 census; one forward under the profiler;
  3f. the SoftGroup++ STPLS3D serving path: a synthetic ~1M-point aerial
     tile (``stpls3d_tile``: 170 m a side, ~433k level-0 voxels at the
     yaml's 1/3 m, the lifted classes above 1e5 active voxels: level 2)
     through ``run_eval`` of ``softgroup++_stpls3d.yaml`` (16 wide, colour
     only in, 300 proposals) as in 3e; then ``TRAIN_STEPS`` steps of
     ``softgroup_stpls3d.yaml``'s train state on the tile (pair keys,
     ``match_low_quality``, ``semantic_weight``), counted apart;
  3g. ``exact_ball_query``: the flagship request with the point-level
     radius-graph grouping on rooms of seeds 100-102, counted; each
     request's grouping again on the CPU from the card's scores and
     offsets (the same partition and labels), and its time on the card
     beside ``cell_cluster_csr``'s;
  4. the training path: the flagship ScanNet train step (the yaml's model
     section, batch 4 x 250k-point rooms, bf16) in both modes of the recipe
     (frozen backbone, then all params), 1 warm-up and 3 timed steps each,
     counters set to 0 just before the timed steps and read just after,
     then one all-params step under the profiler;
  4b. the train CLI: twenty 110k-point ScanNet rooms (seeds 600-619: 20
     steps an epoch) and two val rooms (650-651) written in the prepared
     ``_inst_nostuff.pth`` format, then ``tools_impl.train_cli.main`` on
     copies of the two ScanNet yamls (only ``data_root``, ``work_dir`` and
     stage 2's ``pretrain`` changed): stage 1
     (``softgroup_scannet_backbone.yaml``) for 1 epoch with validation;
     stage 1's last weights written as a reference ``.pth`` (the batch
     norms' running statistics set from one train-mode pass over a CLI
     batch, the semantic head's bias lifted) for stage 2
     (``softgroup_scannet.yaml``, frozen backbone) for 2 epochs, then
     ``--resume --epochs 3``; then the test CLI on stage 2's epoch-2
     checkpoint with ``--out``, and the offline tools on what it wrote
     (``eval_saved``: the CLI's AP, AP50 and AP25; ``eval_det``: box AP
     over a box for each predicted instance; ``visualization``: a ``.ply``
     of each task for one room).  Counters set to 0 just before each
     stage and read just after (validation's launches apart), with each
     step's data wait,
     iteration ms, learning rate, losses, level-0 voxels and peak memory,
     each epoch's wall, checkpoint save / load ms, validation wall and
     metrics, the data wait past each epoch's first step; checks on the
     losses, the schedule, the scheduled validations, the checkpoints
     kept, the resumed state, the frozen backbone and the test CLI's
     metrics, and stage 2's positive proposals a step;
     one step of each stage under the profiler.  One stage-1 step on a
     CLI batch is recorded in phase 2, and its K1 / K2 / K5 / K6 calls at
     the yaml's capacities are held to their plain versions there.  Then
     stage 2's refinement at the CLI's capacities on its positive branch,
     card vs CPU (``cli_positive_check``: the batch's instances as the
     proposals);
  4c. the KITTI train CLI: one ray-cast sweep in each of the ten train
     sequences (seeds 410-419, repeat 4: ten steps of four) and phase 3d's
     two validation sweeps, ``train_cli.main`` on a copy of
     ``softgroup_kitti.yaml`` (all parameters, the instance branch from a
     seeded ``.pth`` with the semantic head lifted, clip 35, 4 workers) for
     one epoch with its validation, counters set to 0 just before and read
     just after; per step the pre-clip gradient norm and whether the clip
     bound, ``num_pos``, the losses, data wait and step time; one step
     under the profiler.  Its K1 (input conv 1->32, level 0) / K2 / K3
     (int64) / K5 / K6 calls at the yaml's capacities, recorded in phase 2,
     are held to their plain versions there;
  4d. data-parallel training (``parallel/ddp.py``, ``TrainStep`` with a
     process group): the flagship train step (the yaml's model section,
     bf16, all parameters) on two ranks spawned over gloo, both on this
     card, each with its own batch of 4 x 250k-point rooms (seeds
     200-203, 204-207) and its own draws: 1 warm-up and 3 timed steps,
     counters set to 0 just before the timed steps and read just after,
     one step under the profiler; checks that the averaged gradients equal
     the mean of the ranks' local gradients (one backward each on the same
     batch and draw with no group), that parameters and batch-norm buffers
     agree bit for bit across the ranks after every step and the buffers
     equal the mean of the local updates, and that K1, K2, K3, K5, K6 and
     K7 launched on each rank; then one rank over NCCL (world 1), whose
     step must give the parameters of the same step with no group bit for
     bit.  Each rank prints a ``[ddp]`` line;
  5. small inputs through the card (f32) against the same port on the CPU
     (plain PyTorch versions of every kernel): a request, then a train step
     held gradient leaf by gradient leaf against control runs
     (``small_train_check``); a request at an odd
     ``instance_voxel_cfg.spatial_shape`` (9: rulebook levels in the
     refinement); the SoftGroup++ S3DIS runner on int64 keys; the train
     step again on int64 keys with low-quality matches and class weights.
Each phase starts with the earlier phases' tensors freed and the
peak-memory counter reset.  Phase 2 also records the ++ S3DIS and ++
STPLS3D requests (K1, K2, K4 and K3 int64 at their shapes; STPLS3D's K1
and K4 16 wide), one STPLS3D train step (K5 16 wide), the
``exact_ball_query`` request (its K2 candidate gather) and one KITTI CLI
step, and holds each of those calls to its plain version.
The line before the last is one JSON object of per-kernel numbers; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time

N_REQUESTS = 3
TRAIN_STEPS = 3
TRAIN_SEED0 = 200
# the S3DIS phase's two rooms (seeds 300-301) and their points
S3DIS_SEED0 = 300
S3DIS_POINTS = 1000000
# the KITTI phase's two sweeps (seeds 400-401): 64 beams x 1900 azimuth
# steps (~120k points, an HDL-64E sweep); a small sweep of 320 steps
KITTI_SEED0 = 400
KITTI_AZIMUTH = 1900
KITTI_SMALL_AZIMUTH = 320
SEMANTIC_BIAS = 2.5
# a train-step gradient leaf's card-vs-CPU gap over the same leaf's gap
# with the plain versions on the card
GRAD_CTRL_FACTOR = 4.0
# a ReLU input that may change sides between the card and the CPU: within
# rounding of 0 (inputs are O(1) after batch norm; the two agree to ~1e-6)
KINK_BOUND = 1e-4
FROZEN = 'frozen backbone'
ALL = 'all params'
# the train CLI's ScanNet rooms: seeds 600-619 (train) and 650-651 (val).
# Sized to the yaml's capacities: these rooms have ~0.57 level-1 voxels a
# level-0 voxel (the yaml's caps 0.5), so at 150k points four augmented
# rooms overflow level 1's 262144; at 110k (~88k / 50k voxels at levels
# 0 / 1 a room, at most 95k / 62k) four rooms fit every level.  20 rooms x
# the yaml's repeat 4 = 20 steps an epoch: enough for the loader's steady
# state past each epoch's first step (the workers' start)
SCANNET_SEED0 = 600
SCANNET_VAL_SEED0 = 650
SCANNET_POINTS = 110000
SCANNET_TRAIN_ROOMS = 20
SCANNET_VAL_ROOMS = 2
# the SoftGroup++ S3DIS and STPLS3D yamls (phases 3e, 3f) and STPLS3D's
# training yaml, under configs/
PLUS_S3DIS_YAML = 'softgroup_pp/softgroup++_s3dis_fold5.yaml'
PLUS_STPLS3D_YAML = 'softgroup_pp/softgroup++_stpls3d.yaml'
STPLS3D_YAML = 'softgroup/softgroup_stpls3d.yaml'
# phase 3f's aerial tile: ~1M points over 170 m x 170 m, ~433k level-0
# voxels at the yaml's 1/3 m (its caps: 1048576 points, 524288 voxels)
STPLS3D_SEED = 500
STPLS3D_POINTS = 1000000
STPLS3D_EXTENT = 170.0
# phase 4c's KITTI train split: one sweep in each of the ten train
# sequences (seeds 410-419), repeat 4 at batch 4: ten steps an epoch
KITTI_TRAIN_SEQS = (0, 1, 2, 3, 4, 5, 6, 7, 9, 10)
KITTI_TRAIN_SEED0 = 410
KITTI_TRAIN_REPEAT = 4
KITTI_TRAIN_STEPS = 10


def small_capacities():
    """The capacities of the small card-vs-CPU checks (20k points)."""
    from softgroup_tpu_torch.model.softgroup import Capacities
    return Capacities(
        points=32768, voxels=(32768, 16384, 8192, 4096, 2048, 1024, 512),
        grouping_points=65536, proposals=64, proposal_entries=65536,
        instances=64, inst_voxels=(16384, 4096), grouping_cells=8192)


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_wrappers() -> dict:
    """The seven kernel wrappers by name (each counts its launches)."""
    from softgroup_tpu_torch.ops import conv_kernel as ck
    from softgroup_tpu_torch.ops import gather_kernel as gk
    from softgroup_tpu_torch.ops import join_kernel as jk
    return dict(rulebook_conv=ck.rulebook_conv, row_gather=gk.row_gather,
                cell_neighbor_join=jk.cell_neighbor_join,
                keyed_conv=ck.keyed_conv,
                rulebook_conv_dw=ck.rulebook_conv_dw,
                sorted_segment_sum=gk.sorted_segment_sum,
                sorted_key_rules_join=jk.sorted_key_rules_join)


def reset_counts() -> None:
    """Every launch counter to 0."""
    from softgroup_tpu_torch.ops import join_kernel as jk
    for w in kernel_wrappers().values():
        w.launches = 0
    jk.cell_neighbor_join.launches64 = 0


def read_counts() -> dict:
    """The launch counters by wrapper (K3's int64 instance apart)."""
    from softgroup_tpu_torch.ops import join_kernel as jk
    return dict({k: w.launches for k, w in kernel_wrappers().items()},
                cell_neighbor_join_int64=jk.cell_neighbor_join.launches64)


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
        from softgroup_tpu_torch.ops import conv_kernel as ck
        from softgroup_tpu_torch.ops import gather_kernel as gk
        from softgroup_tpu_torch.ops import grouping, kernels
        from softgroup_tpu_torch.ops import join_kernel as jk
        from softgroup_tpu_torch.ops import rulebook, sparse_conv
        from softgroup_tpu_torch.data.synthetic import collate_scenes
        from softgroup_tpu_torch.tools_impl import train_cli
        from softgroup_tpu_torch.time_kernels import (
            Recorder, bound, cell_join_bound, cuda_ms, device_reading,
            dw_bound, host_us, k4_args, k5_args, k6_trained_fill,
            k7_trained_fill, nbytes, pick, reading_text, request_args,
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
    t_phase = t_start = time.perf_counter()

    def phase_done(name):
        # the next phase starts with the tensors of this one freed and the
        # peak-memory counter reset, so each phase's peak is its own
        nonlocal t_phase
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        now = time.perf_counter()
        log(f'[phase] {name}: {now - t_phase:.3f} s; the next starts with '
            f'{torch.cuda.memory_allocated() / 2**20:.1f} MB allocated')
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

    # the S3DIS request: the first of two 1M-point rooms written as Area_5
    # scans, through the dataset (x4_split) and the S3DIS yaml's runner
    s3dis_dir = tempfile.TemporaryDirectory(prefix='s3dis_')
    t = time.perf_counter()
    scfg = s3dis_rooms(s3dis_dir.name)
    log(f'[warmup] 2 S3DIS rooms of {S3DIS_POINTS} points written in '
        f'{time.perf_counter() - t:.3f} s')
    snet = lift(entry.build_net(scfg.model, seed=0, device=dev, bf16=True))
    srunner = entry.build_s3dis_runner(snet, scfg)
    sdata = first_scan(scfg)
    with Recorder(sites) as srec:
        sstats = {}
        srunner.run_scene(sdata, stats=sstats)
    log(f'[warmup] S3DIS request done: caps={sstats["caps"]}, '
        f'n_proposals={sstats["n_proposals"]}')
    if sstats['n_proposals'] <= 0:
        raise RuntimeError('warm-up S3DIS request produced no proposals')

    # the SemanticKITTI request: the first of two ray-cast sweeps written
    # as sequence 08 scans, through the dataset and the KITTI yaml's runner
    kitti_dir = tempfile.TemporaryDirectory(prefix='kitti_')
    t = time.perf_counter()
    kcfg = kitti_scans(kitti_dir.name)
    log(f'[warmup] 2 SemanticKITTI sweeps ({KITTI_AZIMUTH} azimuth steps) '
        f'written in {time.perf_counter() - t:.3f} s')
    knet = kitti_lift(entry.build_net(kcfg.model, seed=0, device=dev,
                                      bf16=True))
    krunner = entry.build_s3dis_runner(knet, kcfg)
    kdata = first_scan(kcfg)
    with Recorder(sites) as krec:
        kstats = {}
        krunner.run_scene(kdata, stats=kstats)
    log(f'[warmup] KITTI request done: caps={kstats["caps"]}, '
        f'n_proposals={kstats["n_proposals"]}')
    if kstats['n_proposals'] <= 0:
        raise RuntimeError('warm-up KITTI request produced no proposals')

    # the SoftGroup++ S3DIS request: the first of the S3DIS phase's rooms
    # through the ++ S3DIS yaml's runner (no x4_split, lvl_fusion, the
    # scene pyramid on int64 cell keys)
    p3cfg = yaml_cfg(PLUS_S3DIS_YAML, s3dis_dir.name)
    p3runner = entry.build_s3dis_runner(
        lift(entry.build_net(p3cfg.model, seed=0, device=dev, bf16=True)),
        p3cfg)
    p3stats = forward_recorded(p3runner, first_scan(p3cfg), sites)
    log(f'[warmup] SoftGroup++ S3DIS forward done: caps={p3stats["caps"]}, '
        f'n_proposals={p3stats["n_proposals"]}')
    p3rec = p3stats.pop('recorder')

    # the SoftGroup++ STPLS3D request: an aerial tile through the ++
    # STPLS3D yaml's runner (16 wide, colour only in, int64 cell keys), and
    # one step of STPLS3D's training yaml on the same tile
    st_dir = tempfile.TemporaryDirectory(prefix='stpls3d_')
    t = time.perf_counter()
    stcfg, tile = stpls3d_split(st_dir.name)
    log(f'[warmup] a STPLS3D tile of {len(tile[0])} points written in '
        f'{time.perf_counter() - t:.3f} s')
    strunner = entry.build_s3dis_runner(
        lift(entry.build_net(stcfg.model, seed=0, device=dev, bf16=True)),
        stcfg)
    ststats = forward_recorded(strunner, first_scan(stcfg), sites)
    log(f'[warmup] SoftGroup++ STPLS3D forward done: caps={ststats["caps"]}'
        f', n_proposals={ststats["n_proposals"]}')
    strec = ststats.pop('recorder')
    sttcfg = yaml_cfg(STPLS3D_YAML)
    sttcaps = entry.caps_from_cfg(sttcfg)
    st_state, _ = train_cli.build_train_state(
        lift(train_cli.build_net(sttcfg, dev)), sttcfg, sttcaps, 1)
    with Recorder([(sparse_conv, 'rulebook_conv_dw')]) as sttrec:
        logs = st_state.step(entry.build_train_batch(
            [tile], sttcfg.model, sttcaps,
            scale=sttcfg.data.train.voxel_cfg.scale, device=dev),
            generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
    log(f'[warmup] STPLS3D train step done: loss={float(logs["loss"]):.6f} '
        f'num_pos={float(logs["num_pos"]):.0f}')
    del st_state

    # the flagship request with exact_ball_query (its candidate gather)
    bcfg = cfg.copy()
    bcfg.grouping_cfg.exact_ball_query = True
    with Recorder([(grouping, 'row_gather')]) as brec:
        entry.infer(net, batch, bcfg, caps)
        torch.cuda.synchronize()

    # the KITTI train CLI's sweeps and yaml copy, and one step of its train
    # state on a batch built as its loader builds one (the yaml's caps)
    kcli_dir = tempfile.TemporaryDirectory(prefix='kitti_cli_')
    t = time.perf_counter()
    kcli_path = kitti_train_root(kcli_dir.name)
    log(f'[warmup] {len(KITTI_TRAIN_SEQS)} KITTI train sweeps written in '
        f'{time.perf_counter() - t:.3f} s')
    kcli_batch, kcrec, kcli_caps, logs = cli_record(
        kcli_path, sites + [(sparse_conv, 'rulebook_conv_dw'),
                            (gk, 'sorted_segment_sum')], dev, kitti_lift)
    log(f'[warmup] KITTI train CLI step done: level-0 voxels '
        f'{int(kcli_batch.pyramid.levels[0].vox_valid.sum())} (cap '
        f'{kcli_caps.voxels[0]}), loss={logs["loss"]:.6f} num_pos='
        f'{logs["num_pos"]:.0f} num_neg={logs["num_neg"]:.0f}')

    # the train CLI's rooms and yaml copies, and one stage-1 step on a
    # batch of its loader (the yaml's capacities)
    cli_dir = tempfile.TemporaryDirectory(prefix='scannet_')
    t = time.perf_counter()
    cli_paths = scannet_rooms(cli_dir.name)
    log(f'[warmup] {SCANNET_TRAIN_ROOMS} + {SCANNET_VAL_ROOMS} ScanNet '
        f'rooms of {SCANNET_POINTS} points written in '
        f'{time.perf_counter() - t:.3f} s')
    cli_batch, crec, cli_caps, logs = cli_record(
        cli_paths[0], sites + [(sparse_conv, 'rulebook_conv_dw'),
                               (gk, 'sorted_segment_sum')], dev)
    log(f'[warmup] train CLI stage-1 step on a batch of its training split: '
        f'level-0 voxels {int(cli_batch.pyramid.levels[0].vox_valid.sum())} '
        f'(cap {cli_caps.voxels[0]}), loss={logs["loss"]:.6f}')

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

    def join_case(args, path, tag=''):
        keys, cen, cc, dims, offs, radius = args
        wide = ' int64' if keys.dtype == torch.int64 else ''
        cases.append(dict(
            name=f'K3 cell_neighbor_join{tag}{wide} m={keys.shape[0]}',
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
    # the S3DIS request's, on int64 keys (pair_keys: True)
    s3dis_join = srec.calls['cell_neighbor_join'][0][0]
    if s3dis_join[0].dtype != torch.int64:
        raise RuntimeError(f'the S3DIS request joined {s3dis_join[0].dtype} '
                           f'cell keys, not int64')
    join_case(s3dis_join, 's3dis')
    # the KITTI request's, on int64 keys over its outdoor grid
    kitti_join = krec.calls['cell_neighbor_join'][0][0]
    if kitti_join[0].dtype != torch.int64:
        raise RuntimeError(f'the KITTI request joined {kitti_join[0].dtype} '
                           f'cell keys, not int64')
    join_case(kitti_join, 'kitti')
    # the SoftGroup++ S3DIS and STPLS3D requests' and the KITTI train CLI
    # step's, on int64 keys
    p3join = p3rec.calls['cell_neighbor_join'][0][0]
    stjoin = strec.calls['cell_neighbor_join'][0][0]
    kcjoin = kcrec.calls['cell_neighbor_join'][0][0]
    for args, path, tag in ((p3join, 's3dis_plus', ' s3dis++'),
                            (stjoin, 'stpls3d_plus', ' stpls3d++'),
                            (kcjoin, 'kitti_cli', ' KITTI CLI')):
        if args[0].dtype != torch.int64:
            raise RuntimeError(f'{path} joined {args[0].dtype} cell keys, '
                               f'not int64')
        join_case(args, path, tag)

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

    # the K1, K2 and K4 calls of the SoftGroup++ request, of the S3DIS
    # request (x4_split: four parts in one level-0 grid) and of the KITTI
    # request (the input conv at Cin 1) at their caps
    # (and the SoftGroup++ S3DIS and STPLS3D requests: the heads gathered
    # from the voxels, STPLS3D 16 wide with colour only in)
    for path, calls, rcaps, tag, n_heads, cin, ch in (
            ('serving_plus', prec.calls, pstats['caps'], '++',
             pcfg.semantic_classes + 3, 6, 32),
            ('s3dis', srec.calls, sstats['caps'], 's3dis', None, 6, 32),
            ('kitti', krec.calls, kstats['caps'], 'kitti', None, 1, 32),
            ('s3dis_plus', p3rec.calls, p3stats['caps'], 's3dis++',
             p3cfg.model.semantic_classes + 3, 6, 32),
            ('stpls3d_plus', strec.calls, ststats['caps'], 'stpls3d++',
             stcfg.model.semantic_classes + 3, 3, 16)):
        for label, (a, kw) in request_args(calls, rcaps, tag, n_heads,
                                           cin, ch).items():
            fam, label = label.split(' ', 1)
            if fam == 'K1':
                conv_case(label, a, torch.bfloat16, path)
            elif fam == 'K2':
                gather_case(label, a, path)
            else:
                keyed_case(label, a, kw, path)

    def dw_case(label, args, dtype, path='train_all'):
        feats, g, rules = args
        feats, g = feats.to(dtype), g.to(dtype)
        cases.append(dict(
            name=f'K5 rulebook_conv_dw {label}', key='rulebook_conv_dw',
            path=path, route='cuda', source='softgroup_tpu_torch/csrc/conv.cu',
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

    def segsum_case(label, args, kw, path='train_all'):
        values, seg, s = args
        ok = (seg >= 0) & (seg < s)
        seg_l, vals_f = seg[ok].long(), values[ok].float()
        out_dtype = kw.get('out_dtype', torch.float32)
        cases.append(dict(
            name=f'K6 sorted_segment_sum {label}',
            key='sorted_segment_sum', path=path, route='cuda',
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
            path='train_all',
            bound=rules_bound(args[0], args[1], args[2], len(args[3]))))

    for m_ in tcaps.inst_voxels:
        rules_case(f'm={m_}', pick(rules_calls, lambda a, k: a[0].shape[0]
                                   == m_, f'K7 m={m_}')[0])
    # a trained model's fill: every row a voxel of dense 20^3 grids
    rules_case('trained fill m=131072', k7_trained_fill(dev))

    # the train CLI's stage-1 step at the yaml's capacities (V0 = 524288,
    # 1048576 points): K1, K2, K5, K6 on its level 0 (its K3 and K7 calls
    # have the shapes of the all-params step's: the same grouping cells
    # and proposal grids)
    cv0, cpts = cli_caps.voxels[0], cli_caps.points
    conv_case(f'train CLI L0 subm 32->32 bf16 (V0={cv0})', pick(
        crec.calls['rulebook_conv'], lambda a, k: a[2].shape == (27, cv0)
        and a[1].shape[1:] == (32, 32), 'train CLI L0 subm')[0],
        torch.bfloat16, 'train_cli_backbone')
    gather_case(f'train CLI devoxelize (V0, 32) bf16 (V0={cv0})', pick(
        crec.calls['row_gather'], lambda a, k: a[0].dtype == torch.bfloat16
        and a[0].shape == (cv0, 32), 'train CLI devoxelize')[0],
        'train_cli_backbone')
    dw_case(f'train CLI L0 subm 32->32 bf16 (V0={cv0})', pick(
        crec.calls['rulebook_conv_dw'], lambda a, k: a[2].shape == (27, cv0)
        and a[0].shape[1] == 32 and a[1].shape[1] == 32,
        'train CLI dW L0')[0], torch.bfloat16, 'train_cli_backbone')
    args, kw = pick(crec.calls['sorted_segment_sum'],
                    lambda a, k: a[0].shape[1] == 32,
                    'train CLI devoxelize backward')
    segsum_case(f'train CLI devoxelize backward ({cpts}, 32) bf16', args,
                kw, 'train_cli_backbone')
    # STPLS3D's train step, 16 wide: K5 on level 0 and on the tiny U-Net
    stv0, sti0 = sttcaps.voxels[0], sttcaps.inst_voxels[0]
    for label, rows in ((f'L0 subm 16->16 bf16 (V0={stv0})', stv0),
                        (f'tiny U-Net subm {sti0} 16->16 bf16', sti0)):
        dw_case(f'stpls3d {label}', pick(
            sttrec.calls['rulebook_conv_dw'],
            lambda a, k, r=rows: a[2].shape == (27, r)
            and a[0].shape[1] == 16 and a[1].shape[1] == 16,
            f'stpls3d dW {label}')[0], torch.bfloat16, 'stpls3d_train')
    # exact_ball_query's candidate gather: each entry's 4 + 26 x 4
    # candidates' coordinates
    gather_case(f'ball candidates (P x 108, 3) f32 (P='
                f'{caps.grouping_points})', pick(
                    brec.calls['row_gather'], lambda a, k: a[0].shape[1:]
                    == (3,) and a[1].shape[0] == 108 * a[0].shape[0],
                    'ball candidates')[0], 'ball')
    # the KITTI train CLI's step at its yaml's caps (V0 = 524288): the
    # input conv at Cin 1, level 0's conv, weight gradient, devoxelize and
    # its backward
    kv0 = kcli_caps.voxels[0]
    conv_case(f'KITTI CLI input conv 1->32 bf16 (V0={kv0})', pick(
        kcrec.calls['rulebook_conv'], lambda a, k: a[1].shape[1] == 1,
        'KITTI CLI input conv')[0], torch.bfloat16, 'kitti_cli')
    conv_case(f'KITTI CLI L0 subm 32->32 bf16 (V0={kv0})', pick(
        kcrec.calls['rulebook_conv'], lambda a, k: a[2].shape == (27, kv0)
        and a[1].shape[1:] == (32, 32), 'KITTI CLI L0 subm')[0],
        torch.bfloat16, 'kitti_cli')
    dw_case(f'KITTI CLI L0 subm 32->32 bf16 (V0={kv0})', pick(
        kcrec.calls['rulebook_conv_dw'], lambda a, k: a[2].shape == (27, kv0)
        and a[0].shape[1] == 32 and a[1].shape[1] == 32,
        'KITTI CLI dW L0')[0], torch.bfloat16, 'kitti_cli')
    gather_case(f'KITTI CLI devoxelize (V0, 32) bf16 (V0={kv0})', pick(
        kcrec.calls['row_gather'], lambda a, k: a[0].dtype == torch.bfloat16
        and a[0].shape == (kv0, 32), 'KITTI CLI devoxelize')[0], 'kitti_cli')
    args, kw = pick(kcrec.calls['sorted_segment_sum'],
                    lambda a, k: a[0].shape[1] == 32,
                    'KITTI CLI devoxelize backward')
    segsum_case(f'KITTI CLI devoxelize backward ({kcli_caps.points}, 32) '
                f'bf16', args, kw, 'kitti_cli')
    del rec, trec, prec, srec, crec, p3rec, strec, sttrec, brec, kcrec, out
    del kcjoin
    del conv_calls, keyed_calls, gather_calls, join_calls, dw_calls
    del segsum_calls, rules_calls, train_join_calls, l0_subm, args, kw

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
            # the path whose launches count for the case
            path=c.get('path', 'serving'),
            source=c['source'], replaces=c['replaces'], max_abs_err=err,
            ms=ms, device_ms=reading[0], host_us=wrap_us, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
            library_device_ms=lib_dev[0] if lib_dev else None,
            partial_trace=reading[1] or bool(lib_dev and lib_dev[1])))
    del cases
    torch.cuda.empty_cache()
    phase_done('kernels vs plain')

    # ---- phase 3: the serving path -------------------------------------

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

    # ---- phase 3c: the S3DIS serving path ------------------------------
    s3dis_counts = s3dis_phase(srunner, scfg, sdata, s3dis_join, lift,
                               reset_counts, read_counts, card, dev)
    del srunner, snet, sdata, s3dis_join
    phase_done('S3DIS serving path')

    # ---- phase 3d: the SemanticKITTI panoptic path ---------------------
    kitti_counts = kitti_phase(knet, kcfg, kitti_dir.name, kitti_join,
                               reset_counts, read_counts, card, dev)
    del krunner, knet, kdata, kitti_join
    kitti_dir.cleanup()
    phase_done('KITTI panoptic path')

    # ---- phase 3e: the SoftGroup++ S3DIS serving path ------------------
    # (phase 3c's two 1M-point rooms, the ++ fold-5 yaml: no x4_split)
    p3_counts = plus_eval_phase('s3dis++', p3runner, p3cfg, p3join,
                                reset_counts, read_counts, card)
    del p3runner, p3join
    s3dis_dir.cleanup()
    phase_done('SoftGroup++ S3DIS serving path')

    # ---- phase 3f: the SoftGroup++ STPLS3D serving path and training ---
    st_counts = plus_eval_phase('stpls3d++', strunner, stcfg, stjoin,
                                reset_counts, read_counts, card,
                                min_level=2)
    st_train_counts = stpls3d_train_phase(sttcfg, tile, lift, reset_counts,
                                          read_counts, card, dev)
    del strunner, stjoin, tile
    st_dir.cleanup()
    phase_done('SoftGroup++ STPLS3D serving path and training')

    # ---- phase 3g: exact_ball_query grouping ---------------------------
    ball_counts = ball_phase(net, cfg, caps, make_request, reset_counts,
                             read_counts, card)
    phase_done('exact_ball_query serving path')

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
    del train_batches, batch, logs
    phase_done('training path')

    # ---- phase 4b: the train CLI ---------------------------------------
    cli_counts = train_cli_phase(cli_paths, cli_batch, reset_counts,
                                 read_counts, card, dev)
    # stage 2's positive branch at the CLI's caps, card vs CPU
    cli_positive_check(cli_paths[1], cli_batch, dev)
    del cli_batch
    cli_dir.cleanup()
    phase_done('train CLI')

    # ---- phase 4c: the KITTI train CLI ---------------------------------
    kcli_counts = kitti_cli_phase(kcli_path, kcli_batch, reset_counts,
                                  read_counts, card, dev)
    del kcli_batch
    kcli_dir.cleanup()
    phase_done('KITTI train CLI')

    # ---- phase 4d: data-parallel training -------------------------------
    ddp_counts = ddp_phase(card)
    phase_done('data-parallel training')

    # ---- phase 5: small inputs, card (f32) vs CPU (plain versions) ------
    small_caps = small_capacities()
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
    # an odd instance_voxel_cfg.spatial_shape at inference
    small_odd_shape_check(entry, sg, small_caps, scene, lift, reset_counts,
                          read_counts, dev)
    # pair keys: the ++ S3DIS model section on a 13-class scene (levels up
    # to 3; its component-size thresholds cut to the scene's 20k points)
    p3small = p3cfg.model.copy()
    p3small.grouping_cfg.pyramid_thresholds = [2000, 8000]
    p3small.grouping_cfg.npoint_thr *= 20000 / S3DIS_POINTS
    data = collate_scenes([make_scene(
        np.random.RandomState(7), n_points=20000, n_instances=12,
        semantic_classes=13)], scale=50.0)
    data['scan_ids'] = ['small13']
    plus_small(p3small, data, lift, dev, 'plus-small pair-keys',
               'SoftGroup++ S3DIS')
    # pair-key training: the flagship train section on int64 cell keys,
    # with STPLS3D's low-quality matches and class weights
    ptcfg = entry.train_cfg()
    ptcfg.grouping_cfg.pair_keys = True
    ptcfg.train_cfg.match_low_quality = True
    ptcfg.train_cfg.min_pos_thr = 0.1
    ptcfg.semantic_weight = [1.0, 1.0] + [4.0] * 18
    small_train_check(entry, sg, blocks, small_caps, scene, lift, dev,
                      ptcfg, 'small-train pair-keys')
    phase_done('small card vs CPU')

    for r_ in results:
        key = r_.pop('key')
        by_path = {'serving': serve_counts[key],
                   'serving_plus': plus_counts[key],
                   's3dis': s3dis_counts[key],
                   'kitti': kitti_counts[key],
                   'train_frozen': train_counts[FROZEN][key],
                   'train_all': train_counts[ALL][key],
                   'train_cli_backbone': cli_counts[0][key],
                   'train_cli': cli_counts[1][key],
                   's3dis_plus': p3_counts[key],
                   'stpls3d_plus': st_counts[key],
                   'stpls3d_train': st_train_counts[key],
                   'ball': ball_counts[key],
                   'kitti_cli': kcli_counts[key],
                   'train_ddp': ddp_counts[key]}
        r_['launches'] = by_path[r_.pop('path')]
        r_['launches_by_path'] = by_path
    log(f'[phase] total: {time.perf_counter() - t_start:.3f} s')
    log(card)
    print(json.dumps({'kernels': results}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


class HeadLevels:
    """Keeps a reference to the level-0 semantic head's output of each
    forward (no work inside the timed forward); ``last()`` then gives the
    per-class active rows and pyramid levels that grouping took from the
    latest, ``all()`` those of every forward."""

    def __init__(self, net, gcfg):
        self.net, self.gcfg, self.seen = net, gcfg, []

    def __enter__(self):
        def keep(module, args, out):
            self.seen.append((out, args[1]))
        self.hook = self.net.semantic_linear.register_forward_hook(keep)
        return self

    def __exit__(self, *exc):
        self.hook.remove()

    def _levels(self, seen):
        from softgroup_tpu_torch.model import softgroup as sg
        counts = sg.class_active_counts(*seen, self.gcfg)
        levels = sg.pyramid_levels(counts, self.gcfg)
        return counts.tolist(), [int(v) for v in levels.tolist()]

    def last(self):
        return self._levels(self.seen[-1])

    def all(self):
        return [self._levels(s) for s in self.seen]


def plus_phase(runner, plus_data, lift, pcfg, plus_join, reset_counts,
               read_counts, card, dev) -> dict:
    """Phase 3b (see the module docstring); returns the launch counts of
    the three requests."""
    import numpy as np
    import torch

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
    scfg = pcfg.copy()
    scfg.grouping_cfg.pyramid_thresholds = [2000, 8000]
    plus_small(scfg, plus_data(7, n_points=20000, room=False), lift, dev,
               'plus-small', 'SoftGroup++')
    return plus_counts


def plus_small(scfg, data, lift, dev, tag: str, what: str) -> None:
    """A small scan through the SoftGroup++ runner of the model section
    ``scfg``, on the card (f32) and on the CPU (plain versions): semantic
    and offset heads within 1e-3, proposals (voxel sets) and instances
    within a mean best IoU of 0.99, the same pyramid levels, level 3
    among them."""
    import numpy as np

    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.evaluation.postprocess import to_numpy
    small_caps = small_capacities()
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
    keys = ('int64' if scfg.grouping_cfg.get('pair_keys', True)
            else 'int32')
    log(f'[{tag}] card vs CPU, {what} runner on a {n}-point scene (f32, '
        f'{keys} cell keys, levels by class {lvls[dev]} on the card, '
        f'{lvls["cpu"]} on the CPU): semantic max err {sem_err:.3g} (tol '
        f'1e-3), offset max err {off_err:.3g} (tol 1e-3), proposals (voxel '
        f'sets) {p_a} vs {p_r}, mean best IoU {p_iou:.6f} (tol 0.99), '
        f'instances {i_a} vs {i_r}, mean best IoU with one of its class '
        f'{i_iou:.6f} (tol 0.99)')
    if (sem_err > 1e-3 or off_err > 1e-3 or not p_r or p_iou < 0.99
            or not i_r or i_iou < 0.99 or 3 not in lvls['cpu']
            or lvls[dev] != lvls['cpu']):
        raise RuntimeError(f'card and CPU disagree on the small {what} '
                           f'request')


def s3dis_rooms(root: str):
    """Two synthetic S3DIS rooms of ``S3DIS_POINTS`` points (13 classes,
    things from class 2, seeds 300-301) saved as prepared Area_5 scans
    (labels float64) under ``root``; returns the S3DIS yaml with its test
    split's data_root set to ``root``."""
    import numpy as np
    import torch

    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.data.synthetic import make_room_scene
    for i in range(2):
        seed = S3DIS_SEED0 + i
        xyz, rgb, sem, inst = make_room_scene(
            np.random.RandomState(seed), n_points=S3DIS_POINTS,
            n_instances=24, semantic_classes=13, thing_start=2)
        torch.save((xyz, rgb, sem.astype(np.float64),
                    inst.astype(np.float64)),
                   f'{root}/Area_5_room{seed}_inst_nostuff.pth')
    cfg = entry.s3dis_cfg()
    cfg.data.test.data_root = root
    return cfg


def first_scan(cfg) -> dict:
    """The first collated scan of ``cfg``'s test split, as the loader of
    ``run_eval`` gives it."""
    from softgroup_tpu_torch.data import build_dataloader, build_dataset
    return next(iter(build_dataloader(build_dataset(cfg.data.test),
                                      training=False)))


def s3dis_phase(runner, cfg, data, join_args, lift, reset_counts,
                read_counts, card, dev) -> dict:
    """Phase 3c (see the module docstring); returns the launch counts of
    ``run_eval`` over the two rooms."""
    import numpy as np
    import torch

    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.evaluation.postprocess import to_numpy
    from softgroup_tpu_torch.time_kernels import k3_census
    from softgroup_tpu_torch.tools_impl.test_runner import (InferenceRunner,
                                                            run_eval)
    reset_counts()
    rooms = []
    t = time.perf_counter()
    metrics = run_eval(runner.net, cfg, entry.caps_from_cfg(cfg),
                       cfg.model.num_blocks, device=dev, scene_stats=rooms)
    eval_s = time.perf_counter() - t
    counts = read_counts()
    if len(rooms) != 2:
        raise RuntimeError(f'run_eval ran {len(rooms)} S3DIS rooms, not 2')
    for i, st in enumerate(rooms):
        caps = st['caps']
        log(f'[s3dis] room seed={S3DIS_SEED0 + i} points={st["n_points"]} '
            f'(x4_split) caps: points={caps.points} voxels='
            f'{list(caps.voxels)} grouping_points={caps.grouping_points} '
            f'proposal_entries={caps.proposal_entries} grouping_cells='
            f'{caps.grouping_cells}; level-0 voxels={st["n_voxels"]}; '
            f'host_batch_ms={st["host_batch_ms"]:.3f} (native) '
            f'test_forward_ms={st["forward_ms"]:.3f} get_instances_ms='
            f'{st["postprocess_ms"]:.3f} n_proposals={st["n_proposals"]} '
            f'instances={st["n_instances"]} [{card}]')
        if st['n_proposals'] <= 0 or st['n_instances'] <= 0:
            raise RuntimeError(f'S3DIS room {i}: no proposals or instances')
    stage_s = sum(st['host_batch_ms'] + st['forward_ms']
                  + st['postprocess_ms'] for st in rooms) / 1e3
    log(f'[s3dis] metrics over 2 rooms (random weights: these show the path '
        f'ran, not its quality): '
        + ' '.join(f'{k}={v:.6g}' for k, v in metrics.items())
        + f'; run_eval {eval_s:.3f} s, of which host batch + forward + '
        f'get_instances {stage_s:.3f} s (the rest: loading the scans and '
        f'the evaluators) [{card}]')
    want = {'AP', 'AP_50', 'AP_25', 'mIoU', 'Acc', 'Offset_MAE'}
    if set(metrics) != want or not all(np.isfinite(v)
                                       for v in metrics.values()):
        raise RuntimeError(f'S3DIS metrics missing or not finite: {metrics}')
    log(f'[main-path] S3DIS serving: launches over 2 rooms: '
        f'{json.dumps(counts)}')
    missing = [k for k in ('rulebook_conv', 'row_gather',
                           'cell_neighbor_join', 'keyed_conv',
                           'cell_neighbor_join_int64') if counts[k] <= 0]
    if missing:
        raise RuntimeError(f'kernels never launched on the S3DIS serving '
                           f'path: {missing}')
    if counts['cell_neighbor_join_int64'] != counts['cell_neighbor_join']:
        raise RuntimeError('the S3DIS path joined int32 cell keys')

    k3_census([('S3DIS request int64 keys', join_args,
                counts['cell_neighbor_join'])],
              'chip_smoke', card, [None])
    t = time.perf_counter()
    batch, caps = runner.build_batch(data)
    torch.cuda.synchronize()
    log(f'[s3dis] host batch of room seed={S3DIS_SEED0} again: '
        f'{(time.perf_counter() - t) * 1e3:.3f} ms [{card}]')
    profile(lambda: runner.forward(batch, caps),
            'one S3DIS request (test_forward, x4_split, int64 cell keys)',
            card)
    del batch

    # a small x4_split room through the runner: card (f32) vs CPU (plain
    # versions); the component-size thresholds (a share of each class's
    # mean size in a 1M-point room) cut to the room's 20k points
    small_caps = small_capacities()
    with tempfile.TemporaryDirectory(prefix='s3dis_small_') as root:
        from softgroup_tpu_torch.data.synthetic import make_room_scene
        xyz, rgb, sem, inst = make_room_scene(
            np.random.RandomState(7), n_points=20000, n_instances=8,
            semantic_classes=13, thing_start=2)
        torch.save((xyz, rgb, sem.astype(np.float64),
                    inst.astype(np.float64)),
                   f'{root}/Area_5_small_inst_nostuff.pth')
        small_cfg = cfg.copy()
        small_cfg.data.test.data_root = root
        small_cfg.model.grouping_cfg.npoint_thr *= 20000 / S3DIS_POINTS
        data = first_scan(small_cfg)
    outs, rets = {}, {}
    for d in ('cpu', dev):
        small = InferenceRunner(
            lift(entry.build_net(cfg.model, seed=1, device=d, bf16=False)),
            small_cfg.model, small_caps, cfg.model.num_blocks, device=d)

        def keep(batch, caps, _f=small.forward, _d=d):
            out = _f(batch, caps)
            outs[_d] = to_numpy(out)
            return out
        small.forward = keep
        rets[d] = small.run_scene(data)
    a, r = outs[dev], outs['cpu']
    n = len(data['coords'])
    sem_err = float(np.abs(a['semantic_scores'][:n]
                           - r['semantic_scores'][:n]).max())
    off_err = float(np.abs(a['pt_offsets'][:n] - r['pt_offsets'][:n]).max())
    p_iou, p_a, p_r = best_iou(a, r)
    i_iou, i_a, i_r = instance_iou(rets[dev]['pred_instances'],
                                   rets['cpu']['pred_instances'])
    log(f'[s3dis-small] card vs CPU, runner on a {n}-point x4_split room '
        f'(f32, int64 cell keys): semantic max err {sem_err:.3g} (tol '
        f'1e-3), offset max err {off_err:.3g} (tol 1e-3), proposals {p_a} '
        f'vs {p_r}, mean best IoU {p_iou:.6f} (tol 0.99), instances {i_a} '
        f'vs {i_r}, mean best IoU with one of its class {i_iou:.6f} (tol '
        f'0.99)')
    if (sem_err > 1e-3 or off_err > 1e-3 or not p_r or p_iou < 0.99
            or not i_r or i_iou < 0.99):
        raise RuntimeError('card and CPU disagree on the small S3DIS '
                           'request')
    return counts


def kitti_lift(net):
    """A random init spreads the 19-way softmax near 1/19 < score_thr 0.2,
    so grouping would run on nothing: lift two thing classes (11 car, 12
    bicycle) to ~0.29 each through the semantic head's final bias (more
    lifted classes would share the mass below the threshold)."""
    import torch
    with torch.no_grad():
        net.semantic_linear.final_bias[11:13] = SEMANTIC_BIAS
    return net


def kitti_sweep(seed: int, n_azimuth: int = KITTI_AZIMUTH):
    """One synthetic SemanticKITTI sweep by ray casting: a sensor 1.73 m
    above the ground, 64 beams from -24.9 to +2 degrees, ``n_azimuth``
    steps, returns within 80 m.  A road strip (|y| < 4 m), sidewalks (to
    6 m), terrain beyond, façades and vegetation along both sides, poles
    and trunks on the sidewalks, and 20-40 things each with its own
    instance id (cars 4.5 x 1.8 x 1.5 m and trucks on the road, persons
    and bicyclists on the sidewalks).  Returns (xyz f32 (n, 3), remission
    f32 (n, 1), raw label int32 (n,): the raw semantic id of the yaml's
    learning_map in the low 16 bits, the instance id in the high 16)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    ground, max_range = -1.73, 80.0
    el, az = np.meshgrid(np.deg2rad(np.linspace(-24.9, 2.0, 64)),
                         np.linspace(-np.pi, np.pi, n_azimuth,
                                     endpoint=False), indexing='ij')
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1).reshape(-1, 3)
    inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
    t = np.full(len(d), np.inf)
    sem = np.zeros(len(d), np.int64)
    inst = np.zeros(len(d), np.int64)

    def take(tt, ok, cls, iid=0):
        ok &= (tt > 0) & (tt < t)
        t[ok], sem[ok], inst[ok] = tt[ok], cls, iid

    def box(lo, hi, cls, iid=0):
        t0, t1 = lo * inv, hi * inv
        tmin = np.minimum(t0, t1).max(1)
        take(tmin, np.maximum(t0, t1).min(1) >= tmin, cls, iid)

    def cylinder(cx, cy, r, h, cls):
        a = d[:, 0] ** 2 + d[:, 1] ** 2
        b = -2 * (d[:, 0] * cx + d[:, 1] * cy)
        disc = b * b - 4 * a * (cx * cx + cy * cy - r * r)
        tt = (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a)
        z = tt * d[:, 2]
        take(tt, (disc > 0) & (z > ground) & (z < ground + h), cls)

    down = d[:, 2] < 0
    tg = np.where(down, ground / np.where(down, d[:, 2], -1.0), np.inf)
    yg = np.abs(np.where(down, tg, 0.0) * d[:, 1])
    t[down] = tg[down]
    sem[down] = np.where(yg < 4, 40, np.where(yg < 6, 48, 72))[down]
    for side in (-1, 1):
        x = -max_range
        while x < max_range:
            w = rng.uniform(8, 25)
            if rng.rand() < 0.8:   # a façade 6-15 m high
                y0, depth, h, cls = rng.uniform(10, 14), 8, \
                    rng.uniform(6, 15), 50
            else:                  # vegetation in the gap
                y0, depth, h, cls = rng.uniform(7, 10), 3, \
                    rng.uniform(1, 4), 70
            ys = sorted((side * y0, side * (y0 + depth)))
            box(np.array([x, ys[0], ground]), np.array([x + w, ys[1],
                                                        ground + h]), cls)
            x += w + rng.uniform(0, 4)
    for _ in range(24):
        cx = rng.uniform(-60, 60)
        cy = rng.choice([-1, 1]) * rng.uniform(5.5, 6.5)
        if rng.rand() < 0.5:
            cylinder(cx, cy, 0.1, 6.0, 80)      # pole
        else:
            cylinder(cx, cy, 0.25, 3.0, 71)     # trunk
    things = {'car': ((4.5, 1.8, 1.5), 10), 'truck': ((8.0, 2.5, 3.2), 18),
              'person': ((0.5, 0.5, 1.75), 30),
              'bicyclist': ((1.8, 0.6, 1.7), 31)}
    for i in range(rng.randint(20, 41)):
        size, cls = things[rng.choice(['car', 'car', 'car', 'truck',
                                       'person', 'bicyclist'])]
        size = np.asarray(size)
        cx = rng.uniform(-50, 50)
        cy = (rng.choice([-2.0, 2.0]) + rng.uniform(-0.3, 0.3)
              if cls in (10, 18) else
              rng.choice([-1, 1]) * rng.uniform(4.3, 5.7))
        if abs(cx) < 3 and abs(cy) < 3:   # not on the sensor
            cx += 6
        lo = np.array([cx - size[0] / 2, cy - size[1] / 2, ground])
        box(lo, lo + size, cls, i + 1)
    keep = t <= max_range
    n = int(keep.sum())
    xyz = d[keep] * t[keep, None] + rng.randn(n, 3) * 0.01
    rem = np.clip(rng.rand(n) * 0.3 + np.where(sem[keep] >= 40, 0.2, 0.5),
                  0, 1)
    raw = sem[keep] | (inst[keep] << 16)
    return (xyz.astype(np.float32), rem.astype(np.float32)[:, None],
            raw.astype(np.int32))


def kitti_scans(root: str, seeds=(KITTI_SEED0, KITTI_SEED0 + 1),
                n_azimuth: int = KITTI_AZIMUTH):
    """The sweeps of ``seeds`` as sequence 08 (the val split) under
    ``root`` (``sequences/08/velodyne/00000N.bin``: x, y, z, remission
    f32; ``labels/00000N.label``), beside a copy of the dataset's
    ``semantic-kitti.yaml``; returns the KITTI yaml with its test split's
    data_root set to ``root``."""
    import os
    import shutil

    import numpy as np

    from softgroup_tpu_torch import entry
    seq = os.path.join(root, 'sequences', '08')
    os.makedirs(os.path.join(seq, 'velodyne'), exist_ok=True)
    os.makedirs(os.path.join(seq, 'labels'), exist_ok=True)
    shutil.copy(os.path.join(os.path.dirname(entry.CONFIGS), 'dataset',
                             'kitti', 'semantic-kitti.yaml'), root)
    for i, seed in enumerate(seeds):
        xyz, rem, raw = kitti_sweep(seed, n_azimuth)
        np.concatenate([xyz, rem], 1).tofile(
            os.path.join(seq, 'velodyne', f'{i:06d}.bin'))
        raw.tofile(os.path.join(seq, 'labels', f'{i:06d}.label'))
    cfg = entry.kitti_cfg()
    cfg.data.test.data_root = root
    return cfg


class Hooks:
    """Wraps, for one run of the test CLI: its ``run_split`` (keeps the
    net it built), its ``summarize`` (keeps the results), grouping's
    ``_cell_core`` (keeps each call's cell cap and cell count, with the
    index of the scan it ran for) and the package logger (keeps every
    message)."""

    def __init__(self, stats: list):
        self.stats, self.net, self.results = stats, None, None
        self.cells, self.messages = [], []

    def __enter__(self):
        import logging

        from softgroup_tpu_torch.ops import grouping
        from softgroup_tpu_torch.tools_impl import test_cli
        from softgroup_tpu_torch.util.logger import get_root_logger
        self.saved = [(test_cli, 'run_split', test_cli.run_split),
                      (test_cli, 'summarize', test_cli.summarize),
                      (grouping, '_cell_core', grouping._cell_core)]

        def run_split(net, *a, _f=test_cli.run_split, **kw):
            self.net = net
            return _f(net, *a, **kw)

        def summarize(results, *a, _f=test_cli.summarize, **kw):
            self.results = results
            return _f(results, *a, **kw)

        def cell_core(*a, _f=grouping._cell_core):
            core = _f(*a)
            self.cells.append((len(self.stats), a[7], core['n_cells']))
            return core
        test_cli.run_split, test_cli.summarize = run_split, summarize
        grouping._cell_core = cell_core

        class Keep(logging.Handler):
            def emit(h, record):
                self.messages.append(record.getMessage())
        self.logger = get_root_logger()
        self.handler = Keep()
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        for mod, name, f in self.saved:
            setattr(mod, name, f)
        self.logger.removeHandler(self.handler)


def kitti_phase(net, cfg, root, join_args, reset_counts, read_counts, card,
                dev) -> dict:
    """Phase 3d (see the module docstring); returns the launch counts of
    the test CLI over the two sweeps."""
    import math
    import os

    import numpy as np
    import torch
    import yaml

    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.data import build_dataset
    from softgroup_tpu_torch.evaluation.postprocess import to_numpy
    from softgroup_tpu_torch.time_kernels import k3_census
    from softgroup_tpu_torch.tools_impl import test_cli
    from softgroup_tpu_torch.tools_impl.test_runner import InferenceRunner
    from softgroup_tpu_torch.util.checkpoint import reference_state_dict

    # the net's weights as a reference checkpoint, and the config's file
    pth = os.path.join(root, 'softgroup_kitti.pth')
    torch.save({'net': reference_state_dict(net.state_dict())}, pth)
    cfg_path = os.path.join(root, 'softgroup_kitti.yaml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump(cfg.to_dict(), f)
    out = os.path.join(root, 'out')
    scans = []
    with Hooks(scans) as hooks:
        reset_counts()
        t = time.perf_counter()
        metrics = test_cli.main([cfg_path, '--checkpoint', pth, '--out', out],
                                scene_stats=scans)
        cli_s = time.perf_counter() - t
        counts = read_counts()

    n_state = len(net.state_dict())
    loaded = [m for m in hooks.messages if m.startswith('import: loaded')]
    mine = hooks.net.state_dict()
    unequal = [k for k, v in net.state_dict().items()
               if not torch.equal(v, mine[k])]
    log(f'[kitti] weight import: {loaded} (the net has {n_state} tensors), '
        f'{n_state - len(unequal)}/{n_state} imported tensors equal the '
        f'written weights')
    if loaded != [f'import: loaded {n_state}/{n_state} tensors'] or unequal:
        raise RuntimeError(f'the KITTI weight import is not whole: {loaded}, '
                           f'unequal {unequal[:5]}')
    if len(scans) != 2 or len(hooks.results) != 2:
        raise RuntimeError(f'the test CLI ran {len(scans)} KITTI sweeps, '
                           f'not 2')
    for i, st in enumerate(scans):
        caps = st['caps']
        calls = [(m, int(c)) for s_, m, c in hooks.cells if s_ == i]
        cells = ', '.join(f'valid={min(c, m)} dropped={max(c - m, 0)} '
                          f'(cap {m})' for m, c in calls)
        log(f'[kitti] sweep seed={KITTI_SEED0 + i} points={st["n_points"]} '
            f'caps: points={caps.points} voxels={list(caps.voxels)} '
            f'grouping_points={caps.grouping_points} proposal_entries='
            f'{caps.proposal_entries} grouping_cells={caps.grouping_cells}; '
            f'level-0 voxels={st["n_voxels"]}; grouping cells {cells}; '
            f'host_batch_ms={st["host_batch_ms"]:.3f} (native) '
            f'test_forward_ms={st["forward_ms"]:.3f} '
            f'get_instances_fusion_ms={st["postprocess_ms"]:.3f} '
            f'n_proposals={st["n_proposals"]} instances={st["n_instances"]} '
            f'pasted={st["n_pasted"]} [{card}]')
        if st['n_proposals'] <= 0 or st['n_pasted'] <= 0:
            raise RuntimeError(f'KITTI sweep {i}: no proposals or no '
                               f'instance pasted')
    stage_s = sum(st['host_batch_ms'] + st['forward_ms']
                  + st['postprocess_ms'] for st in scans) / 1e3
    log(f'[kitti] metrics over 2 sweeps (random weights: these show the '
        f'path ran, not its quality): '
        + ' '.join(f'{k}={v:.6g}' for k, v in metrics.items())
        + f'; test CLI {cli_s:.3f} s, of which host batch + forward + '
        f'get_instances + fusion {stage_s:.3f} s (the rest: the weight '
        f'import, loading the scans, the evaluator and the writer) [{card}]')
    if sorted(metrics) != ['PQ'] or not math.isfinite(metrics['PQ']):
        raise RuntimeError(f'KITTI metrics missing or not finite: {metrics}')

    # one .label a sweep: n points x uint32, decoding back to the learned
    # classes through learning_map
    ds = build_dataset(cfg.data.test)
    for r in hooks.results:
        path = os.path.join(out, 'panoptic', r['scan_id'].replace(
            'velodyne', 'predictions') + '.label')
        lab = np.fromfile(path, dtype=np.uint32)
        pan = r['panoptic_preds']
        cls = pan & 0xFFFF
        learned = ds.learning_map[lab & 0xFFFF]
        ok = (len(lab) == len(pan) == len(r['semantic_labels'])
              and (learned[cls < 19] == cls[cls < 19]).all()
              and (learned[cls == 19] == -100).all()
              and ((lab >> 16) == (pan >> 16)).all())
        log(f'[kitti] {os.path.relpath(path, out)}: {len(lab)} points x '
            f'uint32, {len(np.unique(lab >> 16)) - 1} instance ids, '
            f'decodes to the fused classes: {ok}')
        if not ok:
            raise RuntimeError(f'{path} does not decode to the panoptic '
                               f'codes')

    log(f'[main-path] KITTI panoptic: launches over 2 sweeps: '
        f'{json.dumps(counts)}')
    missing = [k for k in ('rulebook_conv', 'row_gather',
                           'cell_neighbor_join', 'keyed_conv',
                           'cell_neighbor_join_int64') if counts[k] <= 0]
    if missing:
        raise RuntimeError(f'kernels never launched on the KITTI panoptic '
                           f'path: {missing}')
    if counts['cell_neighbor_join_int64'] != counts['cell_neighbor_join']:
        raise RuntimeError('the KITTI path joined int32 cell keys')

    k3_census([('KITTI request int64 keys', join_args,
                counts['cell_neighbor_join'])],
              'chip_smoke', card, [None])
    runner = entry.build_s3dis_runner(net, cfg)
    data = first_scan(cfg)
    t = time.perf_counter()
    batch, caps = runner.build_batch(data)
    torch.cuda.synchronize()
    log(f'[kitti] host batch of sweep seed={KITTI_SEED0} again: '
        f'{(time.perf_counter() - t) * 1e3:.3f} ms [{card}]')
    profile(lambda: runner.forward(batch, caps),
            'one KITTI request (test_forward, Cin 1, int64 cell keys)', card)
    del batch

    # a small sweep through the runner: card (f32) vs CPU (plain
    # versions), instances and panoptic codes both kept; the yaml's 200
    # proposals (the first components found are mostly under min_npoint)
    small_cfg = cfg.copy()
    small_cfg.model.test_cfg.eval_tasks = ['instance', 'panoptic']
    with tempfile.TemporaryDirectory(prefix='kitti_small_') as small_root:
        kitti_scans(small_root, seeds=(7,), n_azimuth=KITTI_SMALL_AZIMUTH)
        small_cfg.data.test.data_root = small_root
        data = first_scan(small_cfg)
    outs, rets = {}, {}
    for d in ('cpu', dev):
        small = InferenceRunner(
            kitti_lift(entry.build_net(cfg.model, seed=0, device=d,
                                       bf16=False)),
            small_cfg.model, entry.caps_from_cfg(cfg), cfg.model.num_blocks,
            device=d)

        def keep(batch, caps, _f=small.forward, _d=d):
            o = _f(batch, caps)
            outs[_d] = to_numpy(o)
            return o
        small.forward = keep
        rets[d] = small.run_scene(data)
    a, r = outs[dev], outs['cpu']
    n = len(data['coords'])
    sem_err = float(np.abs(a['semantic_scores'][:n]
                           - r['semantic_scores'][:n]).max())
    off_err = float(np.abs(a['pt_offsets'][:n] - r['pt_offsets'][:n]).max())
    p_iou, p_a, p_r = best_iou(a, r)
    i_iou, i_a, i_r = instance_iou(rets[dev]['pred_instances'],
                                   rets['cpu']['pred_instances'])
    same = float((rets[dev]['panoptic_preds']
                  == rets['cpu']['panoptic_preds']).mean())
    log(f'[kitti-small] card vs CPU, runner on a {n}-point sweep (f32, '
        f'int64 cell keys): semantic max err {sem_err:.3g} (tol 1e-3), '
        f'offset max err {off_err:.3g} (tol 1e-3), proposals {p_a} vs {p_r}, '
        f'mean best IoU {p_iou:.6f} (tol 0.99), instances {i_a} vs {i_r}, '
        f'mean best IoU with one of its class {i_iou:.6f} (tol 0.99), '
        f'panoptic codes equal on {same:.6f} of the points (tol 0.99)')
    if (sem_err > 1e-3 or off_err > 1e-3 or not p_r or p_iou < 0.99
            or not i_r or i_iou < 0.99 or same < 0.99):
        raise RuntimeError('card and CPU disagree on the small KITTI '
                           'request')
    return counts


def scannet_rooms(root: str) -> tuple:
    """``SCANNET_TRAIN_ROOMS`` + ``SCANNET_VAL_ROOMS`` synthetic ScanNet
    rooms of ``SCANNET_POINTS`` points (seeds 600-619, 650-651) saved as
    prepared scans (``train/`` and ``val/``, labels float64, as the
    reference's ``prepare_data_inst.py`` writes them) under ``root``, and
    copies of the two ScanNet yamls with only ``data_root``, ``work_dir``
    and (stage 2) ``pretrain`` changed; returns (stage-1 yaml, stage-2
    yaml, stage 2's pretrain path)."""
    import os

    import numpy as np
    import torch
    import yaml

    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.data.synthetic import make_room_scene
    from softgroup_tpu_torch.util.config import load_config
    for split, n, seed0 in (('train', SCANNET_TRAIN_ROOMS, SCANNET_SEED0),
                            ('val', SCANNET_VAL_ROOMS, SCANNET_VAL_SEED0)):
        os.makedirs(os.path.join(root, split))
        for i in range(n):
            xyz, rgb, sem, inst = make_room_scene(
                np.random.RandomState(seed0 + i), n_points=SCANNET_POINTS,
                n_instances=12)
            torch.save((xyz, rgb, sem.astype(np.float64),
                        inst.astype(np.float64)),
                       os.path.join(root, split, f'scene{seed0 + i:04d}_00'
                                    '_inst_nostuff.pth'))
    pretrain = os.path.join(root, 'backbone.pth')
    paths = []
    for stage, src in enumerate(entry.SCANNET_YAMLS, 1):
        cfg = load_config(src)
        cfg.data.train.data_root = cfg.data.test.data_root = root
        cfg.work_dir = os.path.join(root, f'work_stage{stage}')
        if stage == 2:
            cfg.pretrain = pretrain
        paths.append(os.path.join(root, os.path.basename(src)))
        with open(paths[-1], 'w') as f:
            yaml.safe_dump(cfg.to_dict(), f)
    return paths[0], paths[1], pretrain


def cli_record(cfg_path: str, sites, dev, lift=None):
    """One training batch of the yaml built as a loader worker builds one
    (``host_batch``, then pinned) and one step of its train state
    (``train_cli.build_train_state``, the net through ``lift`` where given)
    on it with the kernel wrappers at ``sites`` recorded; returns (the
    batch on the host, the recorder, the capacities, the step's logs)."""
    import torch

    from softgroup_tpu_torch.time_kernels import Recorder
    from softgroup_tpu_torch.tools_impl import train_cli
    from softgroup_tpu_torch.util.config import load_config
    cfg = load_config(cfg_path)
    batch, caps = host_batch(cfg_path)
    batch = batch.pin_memory()
    net = train_cli.build_net(cfg, dev)
    state, _ = train_cli.build_train_state(lift(net) if lift else net, cfg,
                                           caps, 1)
    with Recorder(sites) as rec:
        logs = state.step(batch.to(dev),
                          generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
    return batch, rec, caps, {k: float(v) for k, v in logs.items()}


def _to_cpu(x):
    """A state dict (nested dicts / lists of tensors) on the host."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _unequal(a, b, what='') -> list:
    """The places where two host state dicts differ (bits, not values)."""
    import torch
    if isinstance(a, torch.Tensor):
        return [] if (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                      and torch.equal(a, b)) else [what]
    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            return [what]
        return [w for k in a for w in _unequal(a[k], b[k], f'{what}.{k}')]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [what]
        return [w for i, (x, y) in enumerate(zip(a, b))
                for w in _unequal(x, y, f'{what}[{i}]')]
    return [] if a == b else [what]


class CliHooks:
    """Wraps, for runs of the train CLI: ``train_cli.validate`` (the
    launches of each validation apart, its wall), ``build_train_state``
    (keeps the net's state dict as imported, before any step) and
    ``CheckpointManager.load`` (keeps the restored net and optimizer state
    dicts and update count)."""

    def __init__(self, read_counts):
        self.read_counts = read_counts
        self.val_counts, self.imported, self.restored = {}, None, None

    def __enter__(self):
        from softgroup_tpu_torch.tools_impl import train_cli
        from softgroup_tpu_torch.util.checkpoint import CheckpointManager
        self.saved = [(train_cli, 'validate', train_cli.validate),
                      (train_cli, 'build_train_state',
                       train_cli.build_train_state),
                      (CheckpointManager, 'load', CheckpointManager.load)]

        def validate(*a, _f=train_cli.validate, **kw):
            before = self.read_counts()
            out = _f(*a, **kw)
            for k, v in self.read_counts().items():
                self.val_counts[k] = self.val_counts.get(k, 0) + v \
                    - before[k]
            return out

        def build_train_state(net, *a, _f=train_cli.build_train_state,
                              **kw):
            self.imported = _to_cpu(net.state_dict())
            return _f(net, *a, **kw)

        def load(mgr, state, *a, _f=CheckpointManager.load, **kw):
            nxt = _f(mgr, state, *a, **kw)
            self.restored = dict(net=_to_cpu(state.net.state_dict()),
                                 optimizer=_to_cpu(
                                     state.optimizer.state_dict()),
                                 updates=state.step.updates)
            return nxt
        train_cli.validate = validate
        train_cli.build_train_state = build_train_state
        CheckpointManager.load = load
        return self

    def __exit__(self, *exc):
        for owner, name, f in self.saved:
            setattr(owner, name, f)


def run_cli(label: str, argv: list, reset_counts, read_counts, card):
    """``train_cli.main(argv)`` with the counters set to 0 just before and
    read just after; prints its steps and epochs and checks the losses and
    the schedule.  Returns (stats, training launches, validation launches,
    hooks)."""
    import math

    import torch

    from softgroup_tpu_torch.tools_impl import train_cli
    from softgroup_tpu_torch.util.config import load_config
    from softgroup_tpu_torch.util.optim import cosine_after_step_schedule
    cfg = load_config(argv[0])
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    held_mb = torch.cuda.memory_allocated() / 2 ** 20
    with CliHooks(read_counts) as hooks:
        reset_counts()
        t = time.perf_counter()
        train_cli.main(argv, stats=stats)
        wall = time.perf_counter() - t
        counts = read_counts()
    val = hooks.val_counts or {k: 0 for k in counts}
    train = {k: v - val[k] for k, v in counts.items()}
    epochs = int(argv[argv.index('--epochs') + 1])
    sched = cosine_after_step_schedule(cfg.optimizer.lr, cfg.step_epoch,
                                       epochs, stats['steps_per_epoch'])
    cap = cfg.tpu.caps.voxels[0]
    for s in stats['steps']:
        log(f'[train-cli] {label} epoch {s["epoch"]} step {s["step"]} '
            f'(update {s["update"]}): data_wait_ms={s["data_ms"]:.3f} '
            f'iter_ms={s["iter_ms"]:.3f} (of which the step '
            f'{s["iter_ms"] - s["data_ms"]:.3f}) lr={s["lr"]!r} level-0 '
            f'voxels={s["l0_voxels"]} (cap {cap}) peak_mem_mb={s["mem_mb"]} '
            + ' '.join(f'{k}={v:.6g}' for k, v in s['logs'].items())
            + f' [{card}]')
        bad = [k for k, v in s['logs'].items() if not math.isfinite(v)]
        if bad:
            raise RuntimeError(f'{label}: non-finite {bad}')
        if s['lr'] != sched(s['update']):
            raise RuntimeError(f'{label}: update {s["update"]} ran at lr '
                               f'{s["lr"]}, the schedule gives '
                               f'{sched(s["update"])}')
    if [s['update'] for s in stats['steps']] != list(range(
            (stats['start_epoch'] - 1) * stats['steps_per_epoch'],
            epochs * stats['steps_per_epoch'])):
        raise RuntimeError(f'{label}: updates out of order')
    for e in stats['epochs']:
        val_s = f'{e["val_s"]:.3f} s' if e['val_s'] is not None else 'none'
        log(f'[train-cli] {label} epoch {e["epoch"]}: training wall '
            f'{e["train_s"]:.3f} s, checkpoint save {e["save_ms"]:.3f} ms, '
            f'validation {val_s}'
            + (' ' + ' '.join(f'{k}={v:.6g}' for k, v in e['val'].items())
               if e['val'] else '') + f' [{card}]')
        n = e['epoch']
        if e['val'] is None and (n % max(cfg.get('save_freq', 4), 1) == 0
                                 or n & (n - 1) == 0):
            raise RuntimeError(f'{label}: epoch {n}\'s scheduled '
                               f'validation returned no metrics')
    data = sorted(s['data_ms'] for s in stats['steps'])
    iters = sorted(s['iter_ms'] for s in stats['steps'])
    steps = sorted(s['iter_ms'] - s['data_ms'] for s in stats['steps'])
    log(f'[train-cli] {label}: main() {wall:.3f} s; {len(iters)} steps, '
        f'iter ms median={statistics.median(iters):.3f} min={iters[0]:.3f} '
        f'max={iters[-1]:.3f}; data wait ms median='
        f'{statistics.median(data):.3f} min={data[0]:.3f} '
        f'max={data[-1]:.3f}; step (iter - data wait) ms median='
        f'{statistics.median(steps):.3f} min={steps[0]:.3f} '
        f'max={steps[-1]:.3f}; data wait share of the steps\' wall '
        f'{sum(data) / sum(iters):.4f}; peak memory '
        f'{stats["steps"][-1]["mem_mb"]} MB, of which {held_mb:.0f} MB held '
        f'before main() (earlier phases\' nets and batches)'
        + (f'; checkpoint load {stats["load_ms"]:.3f} ms'
           if 'load_ms' in stats else '') + f' [{card}]')
    # past each epoch's first step (which waits for the workers' start)
    steady = [s for s in stats['steps'] if s['step'] > 1]
    data = sorted(s['data_ms'] for s in steady)
    first = [round(s['data_ms'], 3) for s in stats['steps'] if s['step'] == 1]
    log(f'[train-cli] {label}: steady state ({len(steady)} steps, each '
        f'epoch\'s first left out): data wait ms median='
        f'{statistics.median(data):.3f} min={data[0]:.3f} max={data[-1]:.3f}'
        f'; iter ms median='
        f'{statistics.median(s["iter_ms"] for s in steady):.3f}; data wait '
        f'share {sum(data) / sum(s["iter_ms"] for s in steady):.4f}; each '
        f'epoch\'s first step waits {first} ms [{card}]')
    log(f'[main-path] train CLI {label}: launches in training '
        f'{json.dumps(train)}; in validation {json.dumps(val)}')
    return stats, train, val, hooks


def train_cli_phase(paths, batch, reset_counts, read_counts, card,
                    dev) -> tuple:
    """Phase 4b (see the module docstring); returns the launch counts of
    the stage-1 and the stage-2 CLI runs (training and validation)."""
    import math
    import os

    import torch

    from softgroup_tpu_torch.data import EpochSampler, build_dataset
    from softgroup_tpu_torch.model.blocks import MaskedBatchNorm
    from softgroup_tpu_torch.tools_impl import test_cli, train_cli
    from softgroup_tpu_torch.util.checkpoint import (load_weights,
                                                     reference_state_dict,
                                                     should_keep)
    from softgroup_tpu_torch.util.config import load_config
    cfg1, cfg2 = load_config(paths[0]), load_config(paths[1])

    # what one worker does for a batch, stage by stage, in this process
    ds = build_dataset(cfg1.data.train)
    idx = EpochSampler(len(ds)).indices(1)[:cfg1.dataloader.train.batch_size]
    t0 = time.perf_counter()
    samples = [ds[i] for i in idx]
    t1 = time.perf_counter()
    collated = ds.collate_fn(samples)
    t2 = time.perf_counter()
    caps1 = train_cli.caps_from_cfg(cfg1)
    train_cli.make_post(caps1, cfg1.tpu.num_levels, cfg1.model.ignore_label)(
        collated)
    t3 = time.perf_counter()
    log(f'[train-cli] one batch of {len(idx)} rooms built in the main '
        f'process: load + augment {(t1 - t0) * 1e3:.3f} ms, collate '
        f'{(t2 - t1) * 1e3:.3f} ms, padded batch + host pyramid '
        f'{(t3 - t2) * 1e3:.3f} ms; the loader runs '
        f'{cfg1.dataloader.train.num_workers} workers')
    del samples, collated

    def ckpt_dir(cfg):
        return os.path.join(cfg.work_dir, 'ckpt')

    def check_kept(cfg, last):
        kept = sorted(int(f.split('_')[1]) for f in os.listdir(ckpt_dir(cfg))
                      if f.startswith('epoch_'))
        want = [e for e in range(1, last) if should_keep(e, cfg.save_freq)] \
            + [last]
        log(f'[train-cli] {os.path.basename(cfg.work_dir)} checkpoints: '
            f'epochs {kept} (should_keep at save_freq {cfg.save_freq}: '
            f'{want})')
        if kept != want:
            raise RuntimeError(f'checkpoints {kept}, not {want}')

    def need(label, counts, keys):
        missing = [k for k in keys if counts[k] <= 0]
        if missing:
            raise RuntimeError(f'kernels never launched on {label}: '
                               f'{missing}')

    # stage 1: the backbone, all parameters, semantic only
    stats1, train1, val1, _ = run_cli(
        'stage 1', [paths[0], '--epochs', '1'], reset_counts, read_counts,
        card)
    need('the train CLI, stage 1', train1, (
        'rulebook_conv', 'row_gather', 'rulebook_conv_dw',
        'sorted_segment_sum'))
    check_kept(cfg1, 1)

    # its last weights as a reference .pth: the running statistics set from
    # one train-mode pass over a CLI batch (a few dozen updates at momentum
    # 0.1 leave them short of the weights' own, and stage 2 runs its frozen
    # backbone on them), the semantic head's final bias lifted on two thing
    # classes (else grouping has nothing to group)
    net = train_cli.build_net(cfg1, dev)
    load_weights(net, os.path.join(ckpt_dir(cfg1), 'epoch_1'))
    norms = [m for m in net.modules() if isinstance(m, MaskedBatchNorm)]
    for m in norms:
        m.momentum = 1.0
    net.train()
    with torch.no_grad():
        net.loss_forward(batch.to(dev), cfg1.model,
                         train_cli.caps_from_cfg(cfg1),
                         generator=torch.Generator().manual_seed(0))
    sd = _to_cpu(net.state_dict())
    del net, norms
    sd['semantic_linear.final_bias'][2:4] = SEMANTIC_BIAS
    torch.save({'net': reference_state_dict(sd)}, paths[2])

    # stage 2: the frozen backbone, the instance head
    stats2, train2, val2, hooks2 = run_cli(
        'stage 2', [paths[1], '--epochs', '2'], reset_counts, read_counts,
        card)
    need('the train CLI, stage 2', train2, (
        'rulebook_conv', 'row_gather', 'cell_neighbor_join',
        'rulebook_conv_dw', 'sorted_segment_sum', 'sorted_key_rules_join'))
    need('the train CLI, stage 2 validation', val2, ('keyed_conv',))
    if not any(s['logs']['num_pos'] + s['logs']['num_neg'] > 0
               for s in stats2['steps']):
        raise RuntimeError('stage 2: no proposal on any step')
    # positives need offsets that part the rooms' touching boxes, which a
    # few dozen updates do not learn; ``cli_positive_check`` (at these
    # caps), phase 5's small train step (separated instances) and the CPU
    # tests hold the positive path
    log(f'[train-cli] stage 2 positive proposals a step: '
        f'{[int(s["logs"]["num_pos"]) for s in stats2["steps"]]}; offset MAE '
        f'of the same backbone weights in eval mode: with stage 1\'s '
        f'running statistics (stage 1, epoch 1) '
        f'{stats1["epochs"][-1]["val"]["Offset_MAE"]:.6g}, with the set ones '
        f'(stage 2, epoch 1) {stats2["epochs"][0]["val"]["Offset_MAE"]:.6g}')
    fixed = tuple(cfg2.model.fixed_modules)
    frozen = sorted(k for k in sd if k.split('.')[0] in fixed)
    bad = [k for k in frozen if not torch.equal(hooks2.imported[k], sd[k])]
    for e in (1, 2):
        got = torch.load(os.path.join(ckpt_dir(cfg2), f'epoch_{e}'),
                         map_location='cpu', weights_only=True)['net']
        bad += [f'epoch {e}: {k}' for k in frozen
                if not torch.equal(got[k], sd[k])]
    log(f'[train-cli] stage 2 frozen backbone ({", ".join(fixed)}): '
        f'{len(frozen) * 3 - len(bad)}/{len(frozen) * 3} tensors equal '
        f'stage 1\'s written weights after the import and after epochs 1 '
        f'and 2')
    if bad:
        raise RuntimeError(f'stage 2 frozen backbone moved: {bad[:5]}')

    # --resume: epoch 3 from epoch 2's checkpoint
    stats3, _, _, hooks3 = run_cli(
        'stage 2 --resume', [paths[1], '--resume', '--epochs', '3'],
        reset_counts, read_counts, card)
    spe = stats2['steps_per_epoch']
    saved = torch.load(os.path.join(ckpt_dir(cfg2), 'epoch_2'),
                       map_location='cpu', weights_only=True)
    bad = _unequal(hooks3.restored['net'], saved['net'], 'net') \
        + _unequal(hooks3.restored['optimizer'], saved['optimizer'],
                   'optimizer')
    log(f'[train-cli] resume: start epoch {stats3["start_epoch"]}, first '
        f'update {stats3["steps"][0]["update"]} (2 x {spe} steps), restored '
        f'update count {hooks3.restored["updates"]}, restored net and '
        f'optimizer state equal the saved epoch-2 state bit for bit: '
        f'{not bad}')
    if (stats3['start_epoch'] != 3 or stats3['steps'][0]['update'] != 2 * spe
            or hooks3.restored['updates'] != 2 * spe or bad):
        raise RuntimeError(f'resume restored the wrong state: {bad[:5]}')
    check_kept(cfg2, 3)

    # the test CLI on stage 2's epoch-2 checkpoint: the in-loop validation
    t = time.perf_counter()
    out_dir = os.path.join(os.path.dirname(paths[1]), 'results')
    scene_stats, results = [], []
    metrics = test_cli.main([paths[1], '--checkpoint',
                             os.path.join(ckpt_dir(cfg2), 'epoch_2'),
                             '--out', out_dir], scene_stats=scene_stats,
                            results_out=results)
    want = next(e['val'] for e in stats2['epochs'] if e['epoch'] == 2)
    same = sorted(metrics) == sorted(want) and all(
        metrics[k] == want[k] or (math.isnan(metrics[k])
                                  and math.isnan(want[k])) for k in want)
    log(f'[train-cli] test CLI on stage 2\'s epoch-2 checkpoint: '
        f'{time.perf_counter() - t:.3f} s, '
        + ' '.join(f'{k}={v:.6g}' for k, v in metrics.items())
        + f'; equal to epoch 2\'s validation: {same}')
    if not same:
        raise RuntimeError(f'test CLI {metrics} vs validation {want}')
    offline_tools_check(paths[1], out_dir, metrics, scene_stats, results)

    # one step of each stage under the profiler, on a batch of the loader
    # (its copy to the card included), from the stage's last checkpoint
    for label, cfg, path, epoch in (('stage 1', cfg1, paths[0], 1),
                                    ('stage 2', cfg2, paths[1], 3)):
        caps = train_cli.caps_from_cfg(cfg)
        net = train_cli.build_net(cfg, dev)
        load_weights(net, os.path.join(ckpt_dir(cfg), f'epoch_{epoch}'))
        state, _ = train_cli.build_train_state(net, cfg, caps, spe)
        gen = torch.Generator().manual_seed(1)
        state.step(batch.to(dev, non_blocking=True), generator=gen)
        profile(lambda: state.step(batch.to(dev, non_blocking=True),
                                   generator=gen),
                f'one train CLI step, {label} '
                f'({os.path.basename(path)})', card)
        del net, state
    return (dict((k, train1[k] + val1[k]) for k in train1),
            dict((k, train2[k] + val2[k]) for k in train2))


def offline_tools_check(cfg_path: str, out_dir: str, metrics: dict,
                        scene_stats: list, results: list) -> None:
    """The port's offline tools on the test CLI's ``--out``: ``eval_saved``
    gives the AP, AP50 and AP25 (nan equal to nan) of ``ScanNetEval`` on
    the CLI's in-memory ``results`` with each score at the four decimals
    that the benchmark's index files hold (the CLI's own, unrounded metrics
    are printed beside them), ``eval_det`` a box for each predicted
    instance, ``visualization`` a ``.ply`` of each task for the first room
    with a vertex a point.  Fails where the CLI predicted no instance (the
    check would hold nothing)."""
    import math
    import os

    from softgroup_tpu_torch.data import DATASETS
    from softgroup_tpu_torch.evaluation import read_mesh_vertices
    from softgroup_tpu_torch.evaluation.instance_eval import ScanNetEval
    from softgroup_tpu_torch.tools_impl import (eval_det, eval_saved,
                                                visualization)
    from softgroup_tpu_torch.util.config import load_config
    n_inst = sum(st['n_instances'] for st in scene_stats)
    if n_inst <= 0:
        raise RuntimeError('the test CLI predicted no instance: the offline '
                           'tools would check nothing')
    t = time.perf_counter()
    res = eval_saved.main([cfg_path, out_dir])
    saved_s = time.perf_counter() - t
    cfg = load_config(cfg_path)
    rounded = ScanNetEval(
        DATASETS[cfg.data.test.type].CLASSES,
        min_npoint=cfg.model.test_cfg.get('min_npoint')).evaluate(
        [[dict(p, conf=float(f'{p["conf"]:.4f}'))
          for p in r['pred_instances']] for r in results],
        [r['gt_instances'] for r in results])
    keys = [('AP', 'all_ap'), ('AP_50', 'all_ap_50%'),
            ('AP_25', 'all_ap_25%')]

    def equal(x, y):
        return x == y or (math.isnan(x) and math.isnan(y))

    same = all(equal(res[b], rounded[b]) for _, b in keys)
    as_cli = all(equal(res[b], metrics[a]) for a, b in keys)
    log(f'[tools] eval_saved on the test CLI\'s --out ({len(scene_stats)} '
        f'rooms, {n_inst} predicted instances): '
        + ' '.join(f'{a}={float(res[b])!r}' for a, b in keys)
        + f' in {saved_s:.3f} s; equal to ScanNetEval on the in-memory '
        f'results at four-decimal scores: {same}; the CLI\'s unrounded '
        + ' '.join(f'{a}={float(metrics[a])!r}' for a, _ in keys)
        + f' (equal: {as_cli})')
    if not same:
        raise RuntimeError(f'eval_saved {res} vs the in-memory results at '
                           f'four-decimal scores {rounded}')
    t = time.perf_counter()
    det = eval_det.main([out_dir, '--iou', '0.25'])
    log(f'[tools] eval_det: mAP@0.25={det["mAP"]:.6g} over {det["n_pred"]} '
        f'predicted boxes ({n_inst} predicted instances) and {det["n_gt"]} '
        f'gt boxes in {time.perf_counter() - t:.3f} s')
    if det['n_pred'] != n_inst or not det['n_gt'] or not math.isfinite(
            det['mAP']):
        raise RuntimeError(f'eval_det: {det["n_pred"]} boxes for {n_inst} '
                           f'instances, {det["n_gt"]} gt, mAP {det["mAP"]}')
    room = sorted(os.listdir(os.path.join(out_dir, 'coords')))[0][:-4]
    n_points = scene_stats[0]['n_points']
    counts = {}
    t = time.perf_counter()
    for task in visualization.TASKS:
        ply = os.path.join(out_dir, f'{room}_{task}.ply')
        visualization.main(['--prediction_path', out_dir, '--room_name',
                            room, '--task', task, '--out', ply])
        counts[task] = len(read_mesh_vertices(ply))
    log(f'[tools] visualization of {room} ({n_points} points): vertices '
        f'{counts} in {time.perf_counter() - t:.3f} s')
    if set(counts.values()) != {n_points}:
        raise RuntimeError(f'visualization: vertices {counts}, not '
                           f'{n_points}')


def yaml_cfg(rel: str, root: str | None = None):
    """A whole config of ``configs/`` (``rel``: its path there), its test
    split's ``data_root`` set to ``root`` where given."""
    import os

    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.util.config import load_config
    cfg = load_config(os.path.join(entry.CONFIGS, rel))
    if root is not None:
        cfg.data.test.data_root = root
    return cfg


def forward_recorded(runner, data: dict, sites) -> dict:
    """The host batch and the device forward of one scan through
    ``runner`` (no host postprocess) with the kernel wrappers at ``sites``
    recorded; returns its caps, proposals and the recorder.  Fails where
    the forward grouped nothing."""
    import torch

    from softgroup_tpu_torch.time_kernels import Recorder
    batch, caps = runner.build_batch(data)
    with Recorder(sites) as rec:
        out = runner.forward(batch, caps)
        torch.cuda.synchronize()
    n_prop = int(out['n_proposals'])
    if n_prop <= 0:
        raise RuntimeError('a recorded forward produced no proposals')
    return dict(caps=caps, n_proposals=n_prop, recorder=rec)


def stpls3d_tile(seed: int, n_points: int = STPLS3D_POINTS,
                 extent: float = STPLS3D_EXTENT):
    """One synthetic STPLS3D aerial tile of ``extent`` m a side and ~
    ``n_points`` points, spread over the surfaces by area: the ground
    (class 0, no instance) but under the buildings, 20 buildings (class 1:
    roofs and walls, 10-18 m footprints on an 8 x 8 grid of slots, 6-20 m
    high), 150 tree crowns (class 4, high vegetation: upper hemispheres of
    2-3.5 m radius at 4-10 m) and 60 vehicles (class 5 cars, class 6
    trucks), each thing its own instance.  Returns (xyz f32 (n, 3), rgb f32
    in [-1, 1], semantic int64, instance int64, -100 where none), the
    layout of a prepared ``_inst_nostuff.pth`` scan."""
    import numpy as np

    from softgroup_tpu_torch.data.synthetic import _sample_box_shell
    rng = np.random.RandomState(seed)
    boxes = [((s % 8 + 0.5) * extent / 8, (s // 8 + 0.5) * extent / 8,
              rng.uniform(10, 18), rng.uniform(10, 18), rng.uniform(6, 20))
             for s in rng.permutation(64)[:20]]
    trees = [(rng.uniform(0, extent), rng.uniform(0, extent),
              rng.uniform(2, 3.5), rng.uniform(4, 10)) for _ in range(150)]
    cars = [(rng.uniform(0, extent), rng.uniform(0, extent), rng.rand() < 0.5)
            for _ in range(60)]
    car_area = 60 * (4.5 * 1.8 + 2 * (4.5 + 1.8) * 1.5)
    area = (extent ** 2 + car_area
            + sum(sx * sy + 2 * (sx + sy) * sz for *_, sx, sy, sz in boxes)
            + sum(2 * np.pi * r * r for *_, r, _ in trees))
    dens = n_points / area
    parts = []
    things = iter(range(len(boxes) + len(trees) + len(cars)))

    def add(xyz, sem):
        inst = -100 if sem == 0 else next(things)
        parts.append((np.asarray(xyz, np.float32),
                      np.full(len(xyz), sem, np.int64),
                      np.full(len(xyz), inst, np.int64)))
    n = int(extent ** 2 * dens)
    g = np.c_[rng.rand(n, 2) * extent, rng.randn(n) * 0.03]
    under = np.zeros(n, bool)
    for cx, cy, sx, sy, _ in boxes:
        under |= (np.abs(g[:, 0] - cx) < sx / 2) & (np.abs(g[:, 1] - cy)
                                                    < sy / 2)
    add(g[~under], 0)
    for cx, cy, sx, sy, sz in boxes:
        add(_sample_box_shell(rng, np.array([cx, cy, sz / 2], np.float32),
                              np.array([sx, sy, sz], np.float32),
                              int((sx * sy + 2 * (sx + sy) * sz) * dens)), 1)
    for x, y, r, h in trees:
        d = rng.randn(int(2 * np.pi * r * r * dens), 3)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d[:, 2] = np.abs(d[:, 2])
        add(np.array([x, y, h]) + d * r, 4)
    for x, y, big in cars:
        size = np.array([8.0, 2.5, 3.2] if big else [4.5, 1.8, 1.5],
                        np.float32)
        add(_sample_box_shell(
            rng, np.array([x, y, size[2] / 2], np.float32), size,
            int((size[0] * size[1] + 2 * (size[0] + size[1]) * size[2])
                * dens)), 6 if big else 5)
    xyz = np.concatenate([p[0] for p in parts])
    rgb = (rng.rand(len(xyz), 3) * 2 - 1).astype(np.float32)
    return (xyz, rgb, np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]))


def stpls3d_split(root: str):
    """The tile of seed ``STPLS3D_SEED`` saved as the ++ STPLS3D yaml's test
    split (``val_250m/``, labels float64) under ``root``; returns (that
    yaml with its test split's data_root set to ``root``, the tile)."""
    import os

    import numpy as np
    import torch
    tile = stpls3d_tile(STPLS3D_SEED)
    xyz, rgb, sem, inst = tile
    os.makedirs(os.path.join(root, 'val_250m'))
    torch.save((xyz, rgb, sem.astype(np.float64), inst.astype(np.float64)),
               os.path.join(root, 'val_250m',
                            f'tile{STPLS3D_SEED}_inst_nostuff.pth'))
    return yaml_cfg(PLUS_STPLS3D_YAML, root), tile


def plus_eval_phase(label: str, runner, cfg, join_args, reset_counts,
                    read_counts, card, min_level: int = 1) -> dict:
    """Phases 3e and 3f: ``run_eval`` of a SoftGroup++ yaml (lvl_fusion,
    scene-pyramid grouping on int64 cell keys) over its test split, the
    counters set to 0 just before and read just after; each scan's caps,
    level-0 voxels, per-class pyramid levels, grouping cells filled and
    dropped, stage times and counts, the metrics and ``run_eval``'s wall;
    K3's int64 census at the first scan's call; one forward under the
    profiler.  Fails where a scan's classes stay under ``min_level``.
    Returns the launch counts."""
    import numpy as np
    import torch

    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.time_kernels import k3_census
    from softgroup_tpu_torch.tools_impl.test_runner import run_eval
    scans = []
    gcfg = cfg.model.grouping_cfg
    with Hooks(scans) as hooks, HeadLevels(runner.net, gcfg) as lv:
        reset_counts()
        t = time.perf_counter()
        metrics = run_eval(runner.net, cfg, entry.caps_from_cfg(cfg),
                           cfg.model.num_blocks, scene_stats=scans)
        eval_s = time.perf_counter() - t
        counts = read_counts()
    levels = lv.all()
    if not scans or len(levels) != len(scans):
        raise RuntimeError(f'{label}: {len(scans)} scans, {len(levels)} '
                           f'forwards')
    ignore = set(gcfg.ignore_classes)
    for i, (st, (active, lvl)) in enumerate(zip(scans, levels)):
        caps = st['caps']
        cells = ', '.join(f'valid={min(c, m)} dropped={max(c - m, 0)} '
                          f'(cap {m})' for s_, m, c in hooks.cells
                          if s_ == i)
        live = {c: (active[c], lvl[c]) for c in range(len(lvl))
                if c not in ignore and active[c] >= cfg.model.test_cfg
                .min_npoint}
        log(f'[{label}] scan {i}: points={st["n_points"]} caps: points={caps.points} voxels='
            f'{list(caps.voxels)} grouping_points={caps.grouping_points} '
            f'proposal_entries={caps.proposal_entries} grouping_cells='
            f'{caps.grouping_cells}; level-0 voxels={st["n_voxels"]}; '
            f'pyramid levels by class {lvl}; classes grouped (active voxels, '
            f'level) {live}; grouping cells {cells}; host_batch_ms='
            f'{st["host_batch_ms"]:.3f} (native) test_forward_plus_ms='
            f'{st["forward_ms"]:.3f} get_instances_ms='
            f'{st["postprocess_ms"]:.3f} n_proposals={st["n_proposals"]} '
            f'instances={st["n_instances"]} [{card}]')
        if st['n_proposals'] <= 0 or st['n_instances'] <= 0:
            raise RuntimeError(f'{label} scan {i}: no proposals or '
                               f'instances')
        if not live or max(v[1] for v in live.values()) < min_level:
            raise RuntimeError(f'{label} scan {i}: no class grouped at '
                               f'pyramid level {min_level} or above')
    stage_s = sum(st['host_batch_ms'] + st['forward_ms']
                  + st['postprocess_ms'] for st in scans) / 1e3
    log(f'[{label}] metrics over {len(scans)} scans (random weights: these '
        f'show the path ran, not its quality): '
        + ' '.join(f'{k}={v:.6g}' for k, v in metrics.items())
        + f'; run_eval {eval_s:.3f} s, of which host batch + forward + '
        f'get_instances {stage_s:.3f} s (the rest: loading the scans and '
        f'the evaluators) [{card}]')
    want = {'AP', 'AP_50', 'AP_25', 'mIoU', 'Acc', 'Offset_MAE'}
    if set(metrics) != want or not all(np.isfinite(v)
                                       for v in metrics.values()):
        raise RuntimeError(f'{label} metrics missing or not finite: '
                           f'{metrics}')
    log(f'[main-path] {label}: launches over {len(scans)} scans: '
        f'{json.dumps(counts)}')
    missing = [k for k in ('rulebook_conv', 'row_gather',
                           'cell_neighbor_join', 'keyed_conv',
                           'cell_neighbor_join_int64') if counts[k] <= 0]
    if missing:
        raise RuntimeError(f'kernels never launched on {label}: {missing}')
    if counts['cell_neighbor_join_int64'] != counts['cell_neighbor_join']:
        raise RuntimeError(f'{label} joined int32 cell keys')
    k3_census([(f'{label} request int64 keys', join_args,
                counts['cell_neighbor_join'])], 'chip_smoke', card, [None])
    batch, caps = runner.build_batch(first_scan(cfg))
    profile(lambda: runner.forward(batch, caps),
            f'one {label} request (test_forward_plus, int64 cell keys)', card)
    del batch
    torch.cuda.empty_cache()
    return counts


def stpls3d_train_phase(cfg, tile, lift, reset_counts, read_counts, card,
                        dev) -> dict:
    """Phase 3f's training part: ``TRAIN_STEPS`` steps of
    ``softgroup_stpls3d.yaml``'s train state (``train_cli.
    build_train_state``: its Adam, schedule; 16 wide, pair keys,
    ``match_low_quality``, ``semantic_weight``) on a batch of the whole tile
    at the yaml's capacities, counters set to 0 just before and read just
    after, after one warm-up step; returns the launch counts."""
    import math

    import torch

    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.tools_impl import train_cli
    caps = entry.caps_from_cfg(cfg)
    net = lift(train_cli.build_net(cfg, dev))
    state, _ = train_cli.build_train_state(net, cfg, caps, TRAIN_STEPS + 1)
    batch = entry.build_train_batch([tile], cfg.model, caps,
                                    scale=cfg.data.train.voxel_cfg.scale,
                                    device=dev)
    gen = torch.Generator().manual_seed(0)
    state.step(batch, generator=gen)
    torch.cuda.synchronize()
    reset_counts()
    for i in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        logs = {k: float(v) for k, v in state.step(
            batch, generator=gen).items()}
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3
        log(f'[stpls3d-train] step {i + 1}: step_ms={step_ms:.3f} level-0 '
            f'voxels={int(batch.pyramid.levels[0].vox_valid.sum())} (cap '
            f'{caps.voxels[0]}) '
            + ' '.join(f'{k}={v:.6g}' for k, v in logs.items())
            + f' peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.3f}'
            f' [{card}]')
        if not all(math.isfinite(v) for v in logs.values()):
            raise RuntimeError(f'STPLS3D train step: non-finite {logs}')
        if logs['num_pos'] + logs['num_neg'] <= 0:
            raise RuntimeError('STPLS3D train step: no proposals')
    counts = read_counts()
    log(f'[main-path] STPLS3D training: launches over {TRAIN_STEPS} steps: '
        f'{json.dumps(counts)}')
    missing = [k for k in ('rulebook_conv', 'row_gather',
                           'cell_neighbor_join', 'cell_neighbor_join_int64',
                           'rulebook_conv_dw', 'sorted_segment_sum',
                           'sorted_key_rules_join') if counts[k] <= 0]
    if missing:
        raise RuntimeError(f'kernels never launched on the STPLS3D train '
                           f'step: {missing}')
    return counts


def ball_phase(net, cfg, caps, make_request, reset_counts, read_counts,
               card) -> dict:
    """Phase 3g: the flagship request with ``exact_ball_query`` on rooms of
    seeds 100-102, counters set to 0 just before and read just after; each
    request's grouping run again on the CPU from the card's scores and
    offsets (the same partition and labels, exactly), and timed on the
    card beside ``cell_cluster_csr``'s on the same inputs.  Returns the
    launch counts."""
    import numpy as np
    import torch

    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.evaluation.postprocess import (get_instances,
                                                            to_numpy)
    from softgroup_tpu_torch.model import softgroup as sg
    bcfg = cfg.copy()
    bcfg.grouping_cfg.exact_ball_query = True
    kept = []
    orig = sg.forward_grouping

    def grouping(*a):
        out = orig(*a)
        kept.append((a, out))
        return out
    sg.forward_grouping = grouping
    try:
        reset_counts()
        for i in range(N_REQUESTS):
            seed = 100 + i
            batch, host_ms = make_request(seed)
            t = time.perf_counter()
            out = entry.infer(net, batch, bcfg, caps)
            torch.cuda.synchronize()
            fwd_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            outs = to_numpy(out)
            n = int(batch.pyramid.point_valid.sum())
            inst = get_instances(f'room{seed}', outs, n, bcfg)
            post_ms = (time.perf_counter() - t) * 1e3
            if not all(np.isfinite(outs[k]).all() for k in (
                    'cls_scores', 'iou_scores', 'mask_scores')):
                raise RuntimeError(f'ball request {seed}: non-finite heads')
            if int(outs['n_proposals']) <= 0:
                raise RuntimeError(f'ball request {seed}: no proposals')
            log(f'[ball] room seed={seed} points={n} host_batch_ms='
                f'{host_ms:.3f} test_forward_ms={fwd_ms:.3f} '
                f'get_instances_ms={post_ms:.3f} n_proposals='
                f'{int(outs["n_proposals"])} instances={len(inst)} [{card}]')
            del batch, out
        counts = read_counts()
    finally:
        sg.forward_grouping = orig
    log(f'[main-path] exact_ball_query serving: launches over {N_REQUESTS} '
        f'requests: {json.dumps(counts)}')
    missing = [k for k in ('rulebook_conv', 'row_gather', 'keyed_conv')
               if counts[k] <= 0]
    if missing or counts['cell_neighbor_join']:
        raise RuntimeError(f'exact_ball_query path: kernels never launched '
                           f'{missing}, cell joins '
                           f'{counts["cell_neighbor_join"]} (want 0)')

    def timed(c, args):
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            orig(*args[:5], c, args[6])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ms)
    for i, (args, out) in enumerate(kept):
        cpu = orig(*[a.cpu() if torch.is_tensor(a) else a
                     for a in args[:5]], bcfg, args[6])
        equal = all(torch.equal(getattr(out, f).cpu(), getattr(cpu, f))
                    for f in out._fields)
        props = int(out.n_proposals)
        entries = int(out.entry_valid.sum())
        log(f'[ball] room seed={100 + i}: {props} proposals, {entries} '
            f'entries; card partition and labels equal to the CPU\'s: '
            f'{equal}; grouping on the card: exact_ball_query '
            f'{timed(bcfg, args):.3f} ms, cell_cluster_csr '
            f'{timed(cfg, args):.3f} ms (median of 3, synchronised) '
            f'[{card}]')
        if not equal:
            raise RuntimeError(f'ball request {100 + i}: card and CPU '
                               f'partitions differ')
    return counts


def kitti_train_root(root: str) -> str:
    """SemanticKITTI's train split as one ray-cast sweep in each of its ten
    sequences (00-07, 09, 10; seeds ``KITTI_TRAIN_SEED0`` on) and its
    validation sequence 08 (phase 3d's sweeps, seeds 400-401) under
    ``root``, and a copy of the KITTI yaml with only ``data_root``,
    ``work_dir``, ``pretrain`` (the seeded net's weights, its semantic head
    lifted as phase 3d's, as a reference ``.pth``) and the train split's
    ``repeat`` (4: ten steps of four an epoch) changed; returns the copy's
    path."""
    import os

    import numpy as np
    import torch
    import yaml

    from softgroup_tpu_torch.tools_impl import train_cli
    from softgroup_tpu_torch.util.checkpoint import reference_state_dict
    cfg = kitti_scans(root)
    for i, seq in enumerate(KITTI_TRAIN_SEQS):
        base = os.path.join(root, 'sequences', f'{seq:02d}')
        os.makedirs(os.path.join(base, 'velodyne'))
        os.makedirs(os.path.join(base, 'labels'))
        xyz, rem, raw = kitti_sweep(KITTI_TRAIN_SEED0 + i)
        np.concatenate([xyz, rem], 1).tofile(
            os.path.join(base, 'velodyne', '000000.bin'))
        raw.tofile(os.path.join(base, 'labels', '000000.label'))
    cfg.data.train.data_root = root
    cfg.data.train.repeat = KITTI_TRAIN_REPEAT
    cfg.work_dir = os.path.join(root, 'work')
    cfg.pretrain = os.path.join(root, 'lifted.pth')
    net = kitti_lift(train_cli.build_net(cfg, 'cpu'))
    torch.save({'net': reference_state_dict(net.state_dict())}, cfg.pretrain)
    path = os.path.join(root, 'softgroup_kitti.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg.to_dict(), f)
    return path


def host_batch(cfg_path: str):
    """The first training batch of a yaml, built in this process as a
    loader worker builds it (load, augment, collate, padded batch + host
    pyramid; epoch 1's sampler order); returns (the SceneBatch on the host,
    the capacities)."""
    from softgroup_tpu_torch.data import EpochSampler, build_dataset
    from softgroup_tpu_torch.tools_impl import train_cli
    from softgroup_tpu_torch.util.config import load_config
    cfg = load_config(cfg_path)
    caps = train_cli.caps_from_cfg(cfg)
    ds = build_dataset(cfg.data.train)
    idx = EpochSampler(len(ds)).indices(1)[:cfg.dataloader.train.batch_size]
    post = train_cli.make_post(caps, cfg.tpu.num_levels,
                               cfg.model.ignore_label,
                               cfg.model.get('with_coords', True))
    return post(ds.collate_fn([ds[i] for i in idx]))[1], caps


def kitti_cli_phase(path: str, batch, reset_counts, read_counts, card,
                    dev) -> dict:
    """Phase 4c: ``train_cli.main`` on the KITTI yaml (all parameters, the
    instance branch, clip 35, batch 4, 4 workers) for one epoch with its
    validation, the counters set to 0 just before and read just after
    (validation's launches apart); per step the pre-clip gradient norm and
    whether the clip bound, ``num_pos`` and the losses (finite); then one
    step under the profiler.  Returns the launch counts (training and
    validation)."""
    import torch

    from softgroup_tpu_torch.tools_impl import train_cli
    from softgroup_tpu_torch.util.config import load_config
    from softgroup_tpu_torch.util.checkpoint import load_weights
    cfg = load_config(path)
    stats, train, val, hooks = run_cli('KITTI', [path, '--epochs', '1'],
                                       reset_counts, read_counts, card)
    clip = cfg.clip_grad_norm
    for s in stats['steps']:
        log(f'[kitti-cli] step {s["step"]}: gradient norm before the clip '
            f'{s["grad_norm"]:.6g} (clip {clip}: '
            f'{"bound" if s["grad_norm"] > clip else "not bound"}), '
            f'num_pos={int(s["logs"]["num_pos"])} '
            f'num_neg={int(s["logs"]["num_neg"])}')
    bound = sum(s['grad_norm'] > clip for s in stats['steps'])
    log(f'[kitti-cli] the clip at {clip} bound on {bound} of '
        f'{len(stats["steps"])} steps; positive proposals a step: '
        f'{[int(s["logs"]["num_pos"]) for s in stats["steps"]]}')
    if len(stats['steps']) != KITTI_TRAIN_STEPS:
        raise RuntimeError(f'KITTI CLI ran {len(stats["steps"])} steps, not '
                           f'{KITTI_TRAIN_STEPS}')
    if not all(s['logs']['num_pos'] + s['logs']['num_neg'] > 0
               for s in stats['steps']):
        raise RuntimeError('KITTI CLI: a step without proposals')
    need = ('rulebook_conv', 'row_gather', 'cell_neighbor_join',
            'cell_neighbor_join_int64', 'rulebook_conv_dw',
            'sorted_segment_sum', 'sorted_key_rules_join')
    missing = [k for k in need if train[k] <= 0] + [
        f'validation {k}' for k in ('keyed_conv', 'cell_neighbor_join_int64')
        if val[k] <= 0]
    if missing:
        raise RuntimeError(f'kernels never launched on the KITTI CLI: '
                           f'{missing}')
    (epoch,) = stats['epochs']
    if sorted(epoch['val'] or ()) != ['PQ']:
        raise RuntimeError(f'KITTI CLI validation: {epoch["val"]}')
    caps = train_cli.caps_from_cfg(cfg)
    net = train_cli.build_net(cfg, dev)
    load_weights(net, f'{cfg.work_dir}/ckpt/epoch_1')
    state, _ = train_cli.build_train_state(net, cfg, caps,
                                           stats['steps_per_epoch'])
    gen = torch.Generator().manual_seed(1)
    state.step(batch.to(dev, non_blocking=True), generator=gen)
    profile(lambda: state.step(batch.to(dev, non_blocking=True),
                               generator=gen),
            'one train CLI step, KITTI (softgroup_kitti.yaml)', card)
    del net, state
    return dict((k, train[k] + val[k]) for k in train)


def ddp_rank(rank: int, world: int, backend: str, init_method: str,
             out_dir: str) -> None:
    """One rank of phase 4d (see the module docstring), on ``cuda:0``;
    writes its record to ``out_dir/w<world>_rank<rank>.json``.  World 2:
    the warm-up step with the local-gradient and buffer checks, 3 timed
    steps counted, one profiled step, every step followed by the replica
    check.  World 1: the same step with and without the group, then 3
    timed steps and one profiled step of the group's."""
    import copy
    import os
    import warnings

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile as tprofile

    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.data.synthetic import make_room_scene
    from softgroup_tpu_torch.parallel import ddp
    from softgroup_tpu_torch.time_kernels import kernel_rows
    from softgroup_tpu_torch.tools_impl.train_cli import QUANT_SEED
    from softgroup_tpu_torch.train import set_train_modes
    from torch.autograd import DeviceType
    warnings.filterwarnings('ignore', message='.*deterministic.*')
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the steps that are compared with a recomputation run deterministic
    # (index_add_ through its sorted path, ~6x slower a step); the timed
    # and profiled steps do not
    torch.use_deterministic_algorithms(True, warn_only=True)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    try:
        tcfg, tcaps = entry.train_cfg(), entry.train_capacities()

        def lifted_net():
            net = entry.build_net(tcfg, seed=0, device='cuda', bf16=True)
            with torch.no_grad():
                net.semantic_linear.final_bias[2:4] = SEMANTIC_BIAS
            return net

        scenes = [make_room_scene(np.random.RandomState(
            TRAIN_SEED0 + 4 * rank + j), n_points=250000, n_instances=12)
            for j in range(4)]
        batch = entry.build_train_batch(scenes, tcfg, tcaps, device='cuda')
        gen = torch.Generator().manual_seed(QUANT_SEED + rank)
        rands = [torch.rand((2, 3), generator=gen)
                 for _ in range(TRAIN_STEPS + 2)]
        net = lifted_net()
        state = entry.build_train_state(net, tcfg, tcaps, (),
                                        dist.group.WORLD)
        rec = dict(rank=rank, world=world, backend=backend,
                   seeds=[TRAIN_SEED0 + 4 * rank + j for j in range(4)])

        def replicas():
            return ddp.replica_max_diff(list(net.parameters())
                                        + list(net.buffers()))

        def gathered_mean(tensors):
            flat = torch.cat([t.detach().reshape(-1).float()
                              for t in tensors]).cpu()
            parts = [torch.empty_like(flat) for _ in range(world)]
            dist.all_gather(parts, flat)
            return sum(parts) / world

        if world > 1:
            # the local gradients and buffer updates: one backward of a
            # copy on the same batch and draw, with no group
            local = copy.deepcopy(net)
            set_train_modes(local, ())
            loss, llogs = local.loss_forward(batch, tcfg, tcaps,
                                             rand=rands[0])
            loss.backward()
            local_g = gathered_mean([
                p.grad if p.grad is not None else torch.zeros_like(p)
                for p in local.parameters()])
            local_b = gathered_mean(ddp.norm_buffers(local))
            rec['local_logs'] = {k: float(v.detach())
                                 for k, v in llogs.items()}
            del local, loss, llogs
            state.step(batch, rand=rands[0])
            avg_g = torch.cat([p.grad.reshape(-1) for p in
                               net.parameters()]).float().cpu()
            avg_b = torch.cat([b.reshape(-1) for b in
                               ddp.norm_buffers(net)]).float().cpu()
            rec['grad_err'] = float((avg_g - local_g).abs().max()
                                    / local_g.abs().max())
            rec['buffer_err'] = float((avg_b - local_b).abs().max()
                                      / local_b.abs().max())
            rec['replica_diff'] = [replicas()]
        else:
            # the same step with no group, from the same weights
            alone = lifted_net()
            astate = entry.build_train_state(alone, tcfg, tcaps, ())
            astate.step(batch, rand=rands[0])
            state.step(batch, rand=rands[0])
            pairs = list(zip(list(net.parameters()) + list(net.buffers()),
                             list(alone.parameters())
                             + list(alone.buffers())))
            rec['unequal'] = int(sum(int((a != b).sum()) for a, b in pairs))
            rec['max_diff'] = float(max((a - b).abs().max()
                                        for a, b in pairs))
            rec['n_values'] = int(sum(a.numel() for a, _ in pairs))
            del alone, astate, pairs
            rec['replica_diff'] = []
        torch.use_deterministic_algorithms(False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        step_ms = []
        for i in range(1, TRAIN_STEPS + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logs = state.step(batch, rand=rands[i])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            if world > 1:
                rec['replica_diff'].append(replicas())
        rec['counts'] = read_counts()
        rec['peak_mb'] = torch.cuda.max_memory_allocated() / 2 ** 20
        rec['step_ms'] = step_ms
        rec['step_ms_median'] = statistics.median(step_ms)
        rec['logs'] = {k: float(v) for k, v in logs.items()}
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            state.step(batch, rand=rands[-1])
            torch.cuda.synchronize()
        if world > 1:
            rec['replica_diff'].append(replicas())
        ranges = {ev.key: ev.cpu_time_total / 1e3
                  for ev in prof.key_averages()
                  if ev.key.startswith('ddp.')
                  and ev.device_type == DeviceType.CPU}
        rows = kernel_rows(prof)
        rec['profile'] = dict(
            ranges_ms=ranges, busy_ms=sum(r[0] for r in rows),
            nccl_ms=sum(r[0] for r in rows if 'nccl' in r[2].lower()),
            copy_ms=sum(r[0] for r in rows if 'memcpy' in r[2].lower()))
        rec['reduced_bytes'] = dict(state.step.reduced_bytes)
        with open(os.path.join(out_dir, f'w{world}_rank{rank}.json'),
                  'w') as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def ddp_phase(card: str) -> dict:
    """Phase 4d (see the module docstring): world 2 over gloo, then world
    1 over NCCL, each rank spawned; prints a ``[ddp]`` line a rank, fails
    on any check, and returns rank 0's launch counts of the world-2
    timed steps."""
    import math
    import os

    import torch

    from softgroup_tpu_torch.parallel import ddp
    need = ('rulebook_conv', 'row_gather', 'cell_neighbor_join',
            'rulebook_conv_dw', 'sorted_segment_sum',
            'sorted_key_rules_join')
    out = tempfile.TemporaryDirectory()
    # a fixed cuBLAS workspace, for the repeated step's equal bits; the
    # ranks start with it (this process's handles already exist)
    os.environ['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'
    recs = {}
    try:
        for world, backend in ((2, 'gloo'), (1, 'nccl')):
            t = time.perf_counter()
            torch.multiprocessing.start_processes(
                ddp_rank, nprocs=world, start_method='spawn',
                args=(world, backend,
                      f'tcp://localhost:{ddp.free_port()}', out.name))
            log(f'[ddp] world {world} over {backend}: {world} spawned '
                f'rank(s) on cuda:0 done in {time.perf_counter() - t:.3f} s')
            for r in range(world):
                with open(os.path.join(out.name,
                                       f'w{world}_rank{r}.json')) as f:
                    recs[world, r] = json.load(f)
    finally:
        os.environ.pop('CUBLAS_WORKSPACE_CONFIG', None)
        out.cleanup()
    bad = []
    for (world, r), rec in sorted(recs.items()):
        prof = rec['profile']
        rng = prof['ranges_ms']
        nb = rec['reduced_bytes']
        checks = (f'(a) averaged vs mean local gradients max err '
                  f'{rec["grad_err"]:.3g} x max|g| (bound 1e-6); (b) '
                  f'replicas\' largest difference after each step '
                  f'{rec["replica_diff"]} (bound 0), buffers vs mean local '
                  f'updates {rec["buffer_err"]:.3g} x max (bound 1e-6)'
                  if world > 1 else
                  f'the step with the group vs with none: '
                  f'{rec["unequal"]} of {rec["n_values"]} values unequal, '
                  f'max diff {rec["max_diff"]:.3g} (bound 0)')
        log(f'[ddp] world {world} {rec["backend"]} rank {r} (rooms '
            f'{rec["seeds"]}): step ms median={rec["step_ms_median"]:.3f} '
            f'{[round(x, 3) for x in rec["step_ms"]]}; gradient all-reduce '
            f'{rng.get("ddp.grad_allreduce", float("nan")):.3f} ms host, '
            f'{nb["grads"]} bytes; buffer all-reduce '
            f'{rng.get("ddp.buffer_allreduce", float("nan")):.3f} ms host, '
            f'{nb["buffers"]} bytes; logs {nb["logs"]} bytes; profiled step: '
            f'device busy {prof["busy_ms"]:.3f} ms, nccl kernels '
            f'{prof["nccl_ms"]:.3f} ms, copies {prof["copy_ms"]:.3f} ms; '
            f'peak {rec["peak_mb"]:.0f} MB; {checks}; losses '
            + ' '.join(f'{k}={v:.6g}' for k, v in rec['logs'].items())
            + f' [{card}]')
        missing = [k for k in need if rec['counts'][k] <= 0]
        log(f'[main-path] data-parallel training, world {world} rank {r}: '
            f'launches over {TRAIN_STEPS} steps: {json.dumps(rec["counts"])}')
        if missing:
            bad.append(f'world {world} rank {r}: kernels never launched '
                       f'{missing}')
        if not all(math.isfinite(v) for v in rec['logs'].values()):
            bad.append(f'world {world} rank {r}: non-finite losses')
        if world > 1 and (rec['grad_err'] > 1e-6 or rec['buffer_err'] > 1e-6
                          or any(d != 0.0 for d in rec['replica_diff'])):
            bad.append(f'world {world} rank {r}: (a) or (b) failed')
        if world == 1 and rec['unequal']:
            bad.append('world 1: the step with the group differs from the '
                       'step with none')
    if recs[2, 0]['logs'] != recs[2, 1]['logs']:
        bad.append('world 2: the ranks\' averaged logs differ')
    if bad:
        raise RuntimeError('; '.join(bad))
    return recs[2, 0]['counts']


def cli_positive_check(cfg_path: str, batch, dev) -> None:
    """Stage 2's refinement at the train CLI's capacities on its positive
    branch: the CLI batch's instances as the proposals (each one a
    proposal whose IoU with its instance is 1), seeded point features,
    the yaml's (r1, r2) draws fixed; ``clusters_voxelization`` ->
    ``instance_head`` -> ``instance_loss`` -> backward on the CPU (plain
    versions) and on the card (f32, each ReLU put on the CPU's side of 0:
    ``AlignedReLU``).  Holds the losses within 1e-4 relative, ``num_pos``
    equal and > 0, and each gradient leaf (and the features' gradient)
    within 1e-3 of its CPU max (f32 sums over up to 131072 voxel rows in
    another order, through the tiny U-Net's ten convs and batch norms)."""
    import torch

    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.model import softgroup as sg
    from softgroup_tpu_torch.tools_impl import train_cli
    from softgroup_tpu_torch.util.config import load_config
    cfg = load_config(cfg_path)
    caps = train_cli.caps_from_cfg(cfg)
    p_max, s_cap = caps.proposals, caps.proposal_entries
    inst = batch.instance_labels
    valid = batch.pyramid.point_valid & (inst >= 0)
    pts = torch.nonzero(valid).reshape(-1)
    ids, seg = torch.unique(inst[pts], return_inverse=True)
    keep = seg < p_max
    pts, seg = pts[keep], seg[keep]
    order = torch.argsort(seg, stable=True)[:s_cap]
    pts, seg = pts[order].to(torch.int32), seg[order].to(torch.int32)
    n_prop = min(len(ids), p_max)
    pad = s_cap - len(pts)
    props = sg.Proposals(
        torch.cat([pts, pts.new_zeros(pad)]),
        torch.cat([seg, seg.new_full((pad,), p_max)]),
        torch.arange(s_cap) < len(pts), torch.tensor(n_prop,
                                                     dtype=torch.int32),
        torch.arange(p_max) < n_prop)
    g = torch.Generator().manual_seed(3)
    feats = torch.randn((inst.shape[0], cfg.model.channels), generator=g)
    rand = torch.tensor([[0.25, 0.5, 0.75], [0.6, 0.3, 0.9]])
    res = {}
    for d in ('cpu', dev):
        net = entry.build_net(cfg.model, seed=0, device=d, bf16=False)
        net.train()
        b = batch.to(d)
        f = feats.to(d).detach().requires_grad_(True)
        pr = sg.Proposals(*(t.to(d) for t in props))
        relu = AlignedReLU(None if d == 'cpu' else res['cpu']['relu'])
        with relu:
            vox_feats, levels, p2v = sg.clusters_voxelization(
                pr, f, b.coords_float,
                float(cfg.model.instance_voxel_cfg.scale),
                int(cfg.model.instance_voxel_cfg.spatial_shape), caps,
                rand=rand.to(d))
            cls, iou, mask = net.instance_head(vox_feats, levels, p2v,
                                               p_max)
            losses = sg.instance_loss(
                cls, mask, iou, pr, b.instance_labels, b.instance_pointnum,
                b.instance_cls, b.instance_valid, cfg.model)
            total, logs = sg.parse_losses(losses)
            total.backward()
        res[d] = dict(
            logs={k: float(v.detach()) for k, v in logs.items()},
            grads=dict({k: p.grad.cpu().double() for k, p in
                        net.named_parameters() if p.grad is not None},
                       feats=f.grad.cpu().double()),
            relu=relu.seen, flips=(relu.flips, relu.worst))
        del net, b, f, pr, vox_feats, levels, cls, iou, mask, total
    c, a = res['cpu'], res[dev]
    loss_err = max(abs(a['logs'][k] - v) / max(abs(v), 1e-12)
                   for k, v in c['logs'].items())
    worst = max((float((a['grads'][k] - v).abs().max())
                 / max(float(v.abs().max()), 1e-30), k)
                for k, v in c['grads'].items())
    flips, kink = a['flips']
    log(f'[cli-positive] stage 2\'s refinement at the train CLI\'s caps '
        f'(proposal_entries {s_cap}, inst_voxels {list(caps.inst_voxels)}) '
        f'on the batch\'s {n_prop} instances as proposals ({len(pts)} '
        f'entries), f32, card vs CPU: num_pos {a["logs"]["num_pos"]:.0f} vs '
        f'{c["logs"]["num_pos"]:.0f}, mask_loss '
        f'{c["logs"]["mask_loss"]:.6g}, max rel loss err {loss_err:.3g} (tol '
        f'1e-4), worst gradient gap / leaf max {worst[0]:.3g} ({worst[1]}; '
        f'tol 1e-3 over {len(c["grads"])} leaves), ReLU flips aligned '
        f'{flips} (max |input| {kink:.3g}, bound {KINK_BOUND:g})')
    if not (c['logs']['num_pos'] > 0 and a['logs']['num_pos']
            == c['logs']['num_pos'] and c['logs']['mask_loss'] > 0):
        raise RuntimeError('the positive branch at the CLI caps: no or '
                           'unequal positives')
    if loss_err > 1e-4 or worst[0] > 1e-3 or kink > KINK_BOUND:
        raise RuntimeError('card and CPU disagree on the refinement\'s '
                           'positive branch at the CLI caps')


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
        # two empty masks (a sem2ins class that no point takes) agree
        best.append(max((float((mx & my).sum() / (mx | my).sum())
                         if (mx | my).any() else 1.0
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
                      dev, tcfg=None, tag: str = 'small-train') -> None:
    """One all-params f32 train step of the flagship training config (or
    the model section ``tcfg``) on a 20k-point scene, from the same weights and the same (r1, r2), on the
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
    tcfg = tcfg or entry.train_cfg()
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
    log(f'[{tag}] one all-params f32 step on a 20k-point scene; ReLU '
        f'inputs put on the CPU\'s side of 0 (flips, max |input| at a flip; '
        f'bound {KINK_BOUND:g}): ' + ', '.join(
            f'{r} {n} ({w:.3g})' for r, (n, w) in kinks.items()))
    raw = failing(raw_card)
    if raw:
        r_, k = raw[0]
        s = float(c['grads'][k].abs().max())
        log(f'[{tag}] without the alignment the card would fail '
            f'{len(raw)} leaves; worst {k} (gap/tol {r_:.3g}): gap over the '
            f'leaf max: card {gap(raw_card, k) / s:.4g}, CPU with the input '
            f'one ulp up {gap(raw_up, k) / s:.4g}')
    log(f'[{tag}] {len(leaves)} gradient leaves, each held to its '
        f'card-vs-CPU gap <= {GRAD_CTRL_FACTOR:g} x max(its gaps with the '
        f'plain versions on the card and with the input one ulp up / down '
        f'on the CPU) + 1e-5 x its max; card vs card again: max gap / leaf '
        f'max {det:.3g}; the 8 leaves with the largest gap / tol (gaps to '
        f'the CPU over the leaf max; rows = rows of its batch norm):')
    for r_, k, s in leaves[:8]:
        log(f'[{tag}]   {k}: gap/tol {r_:.3g}, max {s:.4g}, card '
            f'{gap("card", k) / s:.4g}, plain on card {gap(plain, k) / s:.4g}'
            f', {up} {gap(up, k) / s:.4g}, {down} {gap(down, k) / s:.4g}, '
            f'rows {rows_of(k)}')
    caught = failing(skewed)
    log(f'[{tag}] negative control, K5\'s result x (1 + '
        f'{SkewedK5.SKEW:g}): {len(caught)} leaves fail (must be > 0)')
    log(f'[{tag}] card vs CPU: max rel loss err {loss_err:.3g} (tol '
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

def small_odd_shape_check(entry, sg, small_caps, scene, lift, reset_counts,
                          read_counts, dev) -> None:
    """A flagship request at ``instance_voxel_cfg.spatial_shape`` 9 (odd:
    the refinement U-Net runs on rulebook levels, K7 rules and K1 convs, as
    the reference's does) on the card (f32); the card's
    ``clusters_voxelization`` inputs run again through it and
    ``instance_head`` on the CPU (plain versions, the same weights): cls
    and iou scores and mask scores within 1e-3 (f32 sums in another order
    through the tiny U-Net)."""
    import numpy as np
    import torch
    cfg = entry.flagship_cfg()
    cfg.instance_voxel_cfg.spatial_shape = 9
    nets = {d: lift(entry.build_net(cfg, seed=1, device=d, bf16=False))
            for d in ('cpu', dev)}
    batch = entry.build_batch(scene, cfg, small_caps, device=dev)
    kept = []
    orig = sg.clusters_voxelization

    def keep(*a, **kw):
        kept.append(a)
        return orig(*a, **kw)
    sg.clusters_voxelization = keep
    try:
        reset_counts()
        out = entry.infer(nets[dev], batch, cfg, small_caps)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        sg.clusters_voxelization = orig
    (args,) = kept
    cpu_args = [a.cpu() if torch.is_tensor(a) else
                sg.Proposals(*(t.cpu() for t in a))
                if isinstance(a, sg.Proposals) else a for a in args]
    with torch.no_grad():
        vox, levels, p2v = orig(*cpu_args)
        cls, iou, mask = nets['cpu'].instance_head(vox, levels, p2v,
                                                   small_caps.proposals)
    want = dict(cls_scores=torch.softmax(cls, dim=-1), iou_scores=iou,
                mask_scores=mask)
    errs = {k: float((out[k].cpu() - v).abs().max()) for k, v in
            want.items()}
    n_prop = int(out['n_proposals'])
    log(f'[small-odd] card vs CPU, a 20k-point request at spatial_shape 9 '
        f'(rulebook levels: K7 launches '
        f'{counts["sorted_key_rules_join"]}, K1 {counts["rulebook_conv"]}, '
        f'K4 {counts["keyed_conv"]}), {n_prop} proposals, the card\'s '
        f'refinement inputs on both: max err '
        + ', '.join(f'{k} {v:.3g}' for k, v in errs.items()) + ' (tol 1e-3)')
    if (n_prop <= 0 or counts['sorted_key_rules_join'] <= 0
            or counts['keyed_conv'] or max(errs.values()) > 1e-3
            or not all(np.isfinite(v) for v in errs.values())):
        raise RuntimeError('the odd spatial_shape request: card and CPU '
                           'disagree or the refinement took keyed levels')


if __name__ == '__main__':
    sys.exit(main())
