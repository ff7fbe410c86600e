"""Data parallelism over ``torch.distributed`` (counterpart of
``softgroup_tpu/parallel/mesh.py``).

The reference runs one jitted step over a 1-D device mesh: each device
runs ``loss_forward`` on its own batch with its own draw, then ``pmean``
averages the trainable gradients, the logs and the batch-norm statistics,
and the clip and the update follow on the averages.  Here each device is a
rank, a process that holds its own batch and its own replica of the net;
``train.TrainStep`` with a process group calls ``average_step`` after the
backward, which averages the same three things over the group before the
clip and the update, so every rank takes the same update.

The gradients are all-reduced explicitly, one flat buffer a dtype, and not
through ``DistributedDataParallel``:
- the training entry of ``SoftGroupNet`` is ``loss_forward``; DDP prepares
  its reducer only in ``forward``, so a direct call would silently skip
  the averaging;
- a rank whose batch gives no positive proposals may leave part of the
  refinement branch without a gradient, and the reference averages zeros
  there (Adam still moves its moments): here a missing gradient of a
  trainable parameter becomes zeros, so every rank reduces the same
  buffer and no collective waits on a rank that skipped one;
- the logs and the batch-norm buffers need collectives of their own.
The reduction runs once, after the whole backward (the reference's pmean
point), not in buckets overlapped with it.

Frozen modules (``requires_grad`` False) have no gradient and are not
reduced; the buffers averaged are those of the batch norms in train mode
(``train.set_train_modes`` keeps a frozen backbone's in eval mode).

``stack_batches`` and ``shard_batch`` have no counterpart: each rank holds
its own batch (the training loader gives rank ``r`` of ``n`` batches
``k * n + r``, ``data/loader.py``).  ``make_mesh``'s refusal to build a
mesh larger than the devices present is ``check_devices``.
"""

from __future__ import annotations

import os
import pickle

import torch
import torch.distributed as dist

from ..model.blocks import MaskedBatchNorm
from ..util.trace import span

__all__ = ['all_reduce_mean', 'average_step', 'check_devices',
           'collect_results', 'free_port', 'init_dist', 'norm_buffers',
           'replica_max_diff']


def init_dist(rank: int | None = None, world: int | None = None,
              init_method: str | None = None, backend: str | None = None,
              timeout=None) -> tuple[int, int]:
    """Joins the default process group and returns (rank, world).

    Arguments left None come from the ``torchrun`` environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` through ``env://``).
    World 1 needs no group: (0, 1) is returned and none is made (the
    reference's single-process degrade).  ``backend``: NCCL where a card
    is present, else gloo; ``timeout`` (a ``timedelta``): how long a
    collective waits, the backend's default where None."""
    world = int(os.environ.get('WORLD_SIZE', 1)) if world is None else world
    rank = int(os.environ.get('RANK', 0)) if rank is None else rank
    if world <= 1:
        return 0, 1
    if not dist.is_initialized():
        if backend is None:
            backend = 'nccl' if torch.cuda.is_available() else 'gloo'
        kw = {} if timeout is None else dict(timeout=timeout)
        dist.init_process_group(backend, init_method=init_method or 'env://',
                                world_size=world, rank=rank, **kw)
    return dist.get_rank(), dist.get_world_size()


def free_port() -> int:
    """A free TCP port on localhost (for ``tcp://localhost:<port>``)."""
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def check_devices(n: int, device) -> int:
    """The number of ranks to run for ``--num-devices n`` on ``device``'s
    type: ``n`` where that many are present, every card for ``n = 0`` on
    ``cuda`` and one on the CPU.  CPU ranks are processes, at most one a
    core.  Raises ``ValueError`` where fewer are present (the reference's
    ``make_mesh``); it never falls back to another device type."""
    dev = torch.device(device)
    have = (torch.cuda.device_count() if dev.type == 'cuda'
            else os.cpu_count() or 1)
    if n == 0:
        n = have if dev.type == 'cuda' else 1
    if n < 1 or n > have:
        raise ValueError(
            f'check_devices: requested {n} {dev.type} devices but only '
            f'{have} available')
    return n


def all_reduce_mean(tensors, group=None) -> int:
    """Replaces each tensor by its mean over the group's ranks, in place
    (one flat all-reduce a dtype); returns the bytes reduced."""
    world = dist.get_world_size(group)
    by_dtype: dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    nbytes = 0
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        nbytes += flat.numel() * flat.element_size()
    return nbytes


def norm_buffers(net: torch.nn.Module) -> list:
    """The running statistics (``mean``, ``var``) of the batch norms of
    ``net`` in train mode: the buffers a train step updates."""
    return [b for m in net.modules()
            if isinstance(m, MaskedBatchNorm) and m.training
            for b in (m.mean, m.var)]


def average_step(params, net: torch.nn.Module, log_vars: dict,
                 group=None) -> tuple[dict, dict]:
    """After one backward on each rank: the gradients of ``params`` (the
    trainable ones; a missing one counts as zeros), ``log_vars`` and the
    updated batch-norm buffers of ``net`` replaced by their means over the
    group.  Returns (the averaged logs, the bytes reduced of each kind:
    ``grads``, ``logs``, ``buffers``)."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    nbytes = {}
    with span('ddp.grad_allreduce'):
        nbytes['grads'] = all_reduce_mean(grads, group)
    keys = sorted(log_vars)
    logs = torch.stack([log_vars[k].detach().float() for k in keys])
    with span('ddp.log_allreduce'):
        nbytes['logs'] = all_reduce_mean([logs], group)
    with torch.no_grad(), span('ddp.buffer_allreduce'):
        nbytes['buffers'] = all_reduce_mean(norm_buffers(net), group)
    return dict(zip(keys, logs.unbind())), nbytes


def replica_max_diff(tensors, group=None) -> float:
    """The largest absolute difference between a rank's ``tensors`` and
    rank 0's, over every rank of the group (0.0: the replicas agree bit for
    bit)."""
    flat = torch.cat([t.detach().reshape(-1).double() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=0, group=group)
    diff = (flat - ref).abs().max().reshape(1) if flat.numel() \
        else flat.new_zeros(1)
    dist.all_reduce(diff, op=dist.ReduceOp.MAX, group=group)
    return float(diff)


def collect_results(local_results: list, rank: int, world: int,
                    gather_dir: str | None = None) -> list | None:
    """Gathers per-scan results to rank 0 (the reference's shared-directory
    protocol): each rank pickles its list to ``gather_dir/part_<rank>.pkl``,
    all wait at a barrier, and rank 0 reads the parts and interleaves them
    back to the dataset's order (item i of every rank in rank order, then
    item i + 1); other ranks get None.  World 1 returns the list as it
    is."""
    if world == 1:
        return local_results
    assert gather_dir, 'gathering over ranks needs a shared directory'
    os.makedirs(gather_dir, exist_ok=True)
    with open(os.path.join(gather_dir, f'part_{rank}.pkl'), 'wb') as f:
        pickle.dump(local_results, f)
    dist.barrier()
    if rank != 0:
        return None
    parts = []
    for r in range(world):
        with open(os.path.join(gather_dir, f'part_{r}.pkl'), 'rb') as f:
            parts.append(pickle.load(f))
    merged = []
    for i in range(max(len(p) for p in parts)):
        for p in parts:
            if i < len(p):
                merged.append(p[i])
    return merged
