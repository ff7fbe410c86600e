"""Training CLI: the counterpart of ``tools/train.py`` (the epoch loop over
the config's training split, the cosine-after-step learning rate, gradient
clipping, a checkpoint every epoch with ``--resume``, and validation on
the test split), on one device or data-parallel over several.

    python -m softgroup_tpu_torch.tools_impl.train_cli \
        configs/softgroup/softgroup_scannet_backbone.yaml \
        [--work-dir DIR] [--resume] [--skip-validate] [--epochs N] \
        [--device cpu] [--num-devices N]

The net runs on the card unless ``--device cpu`` is given.
``--num-devices N`` above 1 spawns N ranks, one a card (``cuda:r``, NCCL)
or, with ``--device cpu``, N CPU processes (gloo); 0 takes every card, or
one process on the CPU.  Rank ``r`` trains on the loader's batches ``k * N
+ r`` (``steps_per_epoch = len // N``, ``tools/train.py``'s grouping of N
consecutive batches into a step) with its own quantization draws, and
each step averages the gradients, logs and batch-norm statistics over the
ranks (``train.TrainStep`` with a group, ``parallel/ddp.py``).  Only rank
0 writes the log, the scalars and the checkpoints and validates; the
others wait for it at a barrier.  ``--resume`` loads on every rank.

The loader's workers build each padded batch and its host pyramid
(``data/loader.py``); the main process copies it to the card, pinned, and
steps.  ``pretrain`` (a reference ``.pth``) is imported where the path
exists and skipped, with a log line, where it does not.  Checkpoints go to
``work_dir/ckpt`` (``util/checkpoint.CheckpointManager``); the test CLI's
``--checkpoint`` takes them.
"""

from __future__ import annotations

import argparse
import datetime
import functools
import logging
import os
import os.path as osp
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

from .. import entry
from ..data import build_dataloader, build_dataset
from ..data.padding import build_scene_batch
from ..entry import caps_from_cfg
from ..model.softgroup import Capacities, SoftGroupNet
from ..parallel.ddp import (check_devices, free_port, init_dist,
                            replica_max_diff)
from ..train import TrainState, make_train_step
from ..util.checkpoint import (CheckpointManager, import_reference_weights,
                               load_reference_state_dict)
from ..util.config import load_config
from ..util.logger import (AverageMeter, SummaryWriter, get_max_memory,
                           get_root_logger)
from ..util.optim import build_optimizer, cosine_after_step_schedule, freeze
from .test_runner import run_eval

__all__ = ['build_net', 'build_train_loader', 'build_train_state',
           'caps_from_cfg', 'main', 'make_post', 'parse_args', 'validate']

# the seed of the random quantization draws (the reference's PRNGKey(42));
# data-parallel rank r seeds from QUANT_SEED + r
QUANT_SEED = 42
# how long the ranks wait at a barrier for rank 0's checkpoint and
# validation
BARRIER_TIMEOUT = datetime.timedelta(hours=2)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='softgroup_tpu_torch training')
    p.add_argument('config', help='path to config yaml')
    p.add_argument('--resume', action='store_true')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--skip-validate', action='store_true')
    p.add_argument('--num-devices', type=int, default=0,
                   help='data-parallel ranks (0: every card, or one '
                        'process with --device cpu)')
    p.add_argument('--epochs', type=int, default=0, help='override epochs')
    p.add_argument('--device', default='cuda',
                   help='where the net runs (cuda, or cpu for the plain '
                        'PyTorch versions of the kernels)')
    return p.parse_args(argv)


def build_net(cfg, device='cuda') -> SoftGroupNet:
    """The net of a whole config: its model section (``in_channels``
    included), bf16 from ``tpu.bf16`` (default True), a seeded init."""
    return entry.build_net(cfg.model, device=device,
                           bf16=bool(cfg.get('tpu', {}).get('bf16', True)))


def scene_batch(batch: dict, caps: Capacities, num_levels: int,
                ignore_label: int, with_coords: bool):
    """(scan ids, the collated batch padded into a SceneBatch of CPU
    tensors with its host pyramid)."""
    return batch['scan_ids'], build_scene_batch(
        batch['coords'], batch['coords_float'], batch['feats'],
        batch['semantic_labels'], batch['instance_labels'],
        batch['pt_offset_labels'], batch['instance_pointnum'],
        batch['instance_cls'], batch['spatial_shape'], caps, num_levels,
        ignore_label, with_coords=with_coords, device='cpu')


def make_post(caps: Capacities, num_levels: int, ignore_label: int,
              with_coords: bool = True):
    """The loader's ``post``: ``scene_batch`` at these settings (a
    partial, so a worker process can receive it)."""
    return functools.partial(scene_batch, caps=caps, num_levels=num_levels,
                             ignore_label=ignore_label,
                             with_coords=with_coords)


def build_train_loader(cfg, caps: Capacities, logger=None,
                       pin_memory: bool = False, rank: int = 0,
                       world: int = 1):
    """The training loader of ``cfg.data.train`` at the config's batch
    size and workers, yielding (scan ids, SceneBatch on the CPU); rank
    ``rank`` of ``world`` gets batches ``k * world + rank``."""
    return build_dataloader(
        build_dataset(cfg.data.train, logger),
        batch_size=cfg.dataloader.train.batch_size,
        num_workers=cfg.dataloader.train.num_workers, training=True,
        post=make_post(caps, cfg.tpu.num_levels, cfg.model.ignore_label,
                       cfg.model.get('with_coords', True)),
        pin_memory=pin_memory, rank=rank, world=world)


def build_train_state(net: SoftGroupNet, cfg, caps: Capacities,
                      steps_per_epoch: int, group=None):
    """(the train state of ``net`` for a whole config, its schedule): the
    config's optimizer over the parameters outside ``fixed_modules``, the
    cosine-after-step schedule, ``clip_grad_norm`` where set; ``group``:
    the process group each step averages over."""
    schedule = cosine_after_step_schedule(
        cfg.optimizer.lr, cfg.step_epoch, cfg.epochs, steps_per_epoch)
    fixed = tuple(cfg.model.get('fixed_modules', []))
    optimizer = build_optimizer(freeze(net, fixed), cfg.optimizer, schedule)
    step = make_train_step(net, cfg.model, caps, optimizer, fixed, schedule,
                           cfg.get('clip_grad_norm'), group)
    return TrainState(net, optimizer, step), schedule


def main(argv=None, stats: dict | None = None) -> None:
    """Runs the CLI on ``argv`` (None: ``sys.argv``).  ``stats``, when
    given, receives ``steps_per_epoch``, ``start_epoch``, ``load_ms``
    (``--resume``), per step (``steps``) the epoch, scan ids, update,
    learning rate, data wait and iteration ms, level-0 voxels, peak
    memory, losses and the gradients' global norm before the clip (None
    without ``clip_grad_norm``), and per epoch (``epochs``) its training
    wall, checkpoint save ms, validation wall and metrics.  With several
    ranks they are rank 0's, with ``world`` and ``replica_max_diff`` (the
    largest difference of a rank's final parameters and buffers from rank
    0's).  Raises ``ValueError`` where fewer devices are present than
    ``--num-devices`` asks."""
    args = parse_args(argv)
    world = check_devices(args.num_devices, args.device)
    if stats is None:
        stats = {}
    if world == 1:
        _run(args, 0, 1, stats)
        return
    fd, stats_path = tempfile.mkstemp(suffix='.pkl')
    os.close(fd)
    try:
        torch.multiprocessing.start_processes(
            _rank_main, nprocs=world, start_method='spawn',
            args=(args, world, f'tcp://localhost:{free_port()}',
                  stats_path))
        with open(stats_path, 'rb') as f:
            stats.update(pickle.load(f))
    finally:
        os.remove(stats_path)


def _rank_main(rank: int, args, world: int, init_method: str,
               stats_path: str) -> None:
    """Rank ``rank`` of a data-parallel run: its device, its place in the
    process group, the run; rank 0 pickles its stats to ``stats_path``."""
    if torch.device(args.device).type == 'cuda':
        torch.cuda.set_device(rank)
        args.device = f'cuda:{rank}'
        backend = 'nccl'
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        backend = 'gloo'
    init_dist(rank, world, init_method, backend, timeout=BARRIER_TIMEOUT)
    try:
        stats = {}
        _run(args, rank, world, stats)
        if rank == 0:
            with open(stats_path, 'wb') as f:
                pickle.dump(stats, f)
    finally:
        dist.destroy_process_group()


def _run(args, rank: int, world: int, stats: dict) -> None:
    """One rank of ``main``: the config, the work dir, rank 0's log file
    and scalar writer, then the training."""
    cfg = load_config(args.config)
    if args.epochs:
        cfg.epochs = args.epochs
    work_dir = args.work_dir or cfg.get('work_dir') or osp.join(
        './work_dirs', osp.splitext(osp.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    logger = get_root_logger(rank=rank)
    log_file = None
    if rank == 0:
        log_file = logging.FileHandler(osp.join(work_dir, 'train.log'))
        log_file.setFormatter(logging.Formatter(
            '%(asctime)s - %(levelname)s - %(message)s'))
        logger.addHandler(log_file)
    writer = SummaryWriter(work_dir, rank)
    try:
        _train(args, cfg, work_dir, logger, writer, stats, rank, world)
    finally:
        writer.close()
        if log_file is not None:
            logger.removeHandler(log_file)
            log_file.close()


def _train(args, cfg, work_dir: str, logger, writer, stats: dict,
           rank: int = 0, world: int = 1) -> None:
    """The body of ``main`` on rank ``rank`` of ``world``."""
    device = torch.device(args.device)
    logger.info(f'config: {args.config}  device: {device}' + (
        f' ({torch.cuda.get_device_name(device)})'
        if device.type == 'cuda' else '') + (
        f'  ranks: {world} ({dist.get_backend()})' if world > 1 else ''))
    caps = caps_from_cfg(cfg)
    num_levels = cfg.tpu.num_levels
    net = build_net(cfg, device)
    loader = build_train_loader(cfg, caps, logger,
                                pin_memory=device.type == 'cuda', rank=rank,
                                world=world)
    steps_per_epoch = max(len(loader), 1)
    pretrain = cfg.get('pretrain')
    if pretrain and osp.exists(pretrain):
        logger.info(f'importing pretrain {pretrain}')
        net.load_state_dict(import_reference_weights(
            net.state_dict(), load_reference_state_dict(pretrain), logger))
    elif pretrain:
        logger.info(f'pretrain {pretrain} not found: not imported')
    state, schedule = build_train_state(
        net, cfg, caps, steps_per_epoch,
        dist.group.WORLD if world > 1 else None)

    ckpt = CheckpointManager(work_dir, cfg.get('save_freq', 0), rank)
    start_epoch = 1
    if args.resume:
        t = time.perf_counter()
        start_epoch = ckpt.load(state)
        stats['load_ms'] = (time.perf_counter() - t) * 1e3
        logger.info(f'resumed at epoch {start_epoch}')
    stats.update(steps_per_epoch=steps_per_epoch, start_epoch=start_epoch,
                 steps=[], epochs=[], world=world)
    generator = torch.Generator().manual_seed(QUANT_SEED + rank)

    for epoch in range(start_epoch, cfg.epochs + 1):
        t_epoch = time.perf_counter()
        loader.set_epoch(epoch)
        iter_time, data_time = AverageMeter(), AverageMeter()
        meters: dict[str, AverageMeter] = {}
        end = time.time()
        step_in_epoch = 0
        for scan_ids, batch in loader:
            data_time.update(time.time() - end)
            n_voxels = int(batch.pyramid.levels[0].vox_valid.sum())
            logs = state.step(batch.to(device, non_blocking=True),
                              generator=generator)
            step_in_epoch += 1
            logs = {k: float(v) for k, v in logs.items()}
            for k, v in logs.items():
                meters.setdefault(k, AverageMeter()).update(v)
            iter_time.update(time.time() - end)
            stats['steps'].append(dict(
                epoch=epoch, step=step_in_epoch, scan_ids=list(scan_ids),
                update=state.step.updates - 1,
                lr=state.optimizer.param_groups[0]['lr'],
                data_ms=data_time.val * 1e3, iter_ms=iter_time.val * 1e3,
                l0_voxels=n_voxels, mem_mb=get_max_memory(), logs=logs,
                grad_norm=(None if state.step.grad_norm is None
                           else float(state.step.grad_norm))))
            end = time.time()
            if step_in_epoch % 10 == 0:
                lr = schedule(state.step.updates)
                remain = (steps_per_epoch - step_in_epoch) \
                    + (cfg.epochs - epoch) * steps_per_epoch
                eta = remain * iter_time.avg
                mstr = ', '.join(f'{k}: {m.avg:.4f}'
                                 for k, m in meters.items())
                logger.info(
                    f'Epoch [{epoch}/{cfg.epochs}][{step_in_epoch}/'
                    f'{steps_per_epoch}] lr {lr:.2g} eta {eta / 3600:.1f}h '
                    f'mem {get_max_memory()}MB '
                    f'iter {iter_time.avg:.2f}s ({mstr})')
        train_s = time.perf_counter() - t_epoch
        for k, m in meters.items():
            writer.add_scalar(f'train/{k}', m.avg, epoch)
        writer.add_scalar('train/lr', schedule(state.step.updates), epoch)
        t = time.perf_counter()
        ckpt.save(state, epoch)
        save_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        metrics = None
        if rank == 0 and not args.skip_validate and (
                epoch % max(cfg.get('save_freq', 4), 1) == 0
                or (epoch & (epoch - 1)) == 0):
            metrics = validate(net, cfg, caps, num_levels, logger, writer,
                               epoch, device)
        if world > 1:
            dist.barrier()
        stats['epochs'].append(dict(
            epoch=epoch, train_s=train_s, save_ms=save_ms,
            val_s=time.perf_counter() - t if metrics is not None else None,
            val=metrics))
    if world > 1:
        diff = replica_max_diff(list(net.parameters()) + list(net.buffers()))
        stats['replica_max_diff'] = diff
        logger.info(f'parameters and buffers across the {world} ranks: '
                    f'largest difference from rank 0\'s {diff}')
    logger.info('training done')


def validate(net: SoftGroupNet, cfg, caps: Capacities, num_levels: int,
             logger, writer, epoch: int, device='cuda') -> dict | None:
    """``run_eval`` of ``net`` (in eval mode) on ``cfg.data.test``: its
    metrics, also written as ``val/<k>`` scalars; None, with a log line,
    where the split is missing or empty."""
    net.eval()
    try:
        results = run_eval(net, cfg, caps, num_levels, logger,
                           device=device)
    except (AssertionError, FileNotFoundError) as e:
        logger.info(f'validation skipped: {e}')
        return None
    for k, v in results.items():
        if isinstance(v, (int, float)):
            writer.add_scalar(f'val/{k}', v, epoch)
            logger.info(f'val {k}: {v:.4f}')
    return results


if __name__ == '__main__':
    main()
