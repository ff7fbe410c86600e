"""Dataset registry and loaders (counterpart of ``softgroup_tpu/data/
__init__.py``'s ``build_dataset`` / ``build_dataloader`` and of
``data/loader.py``), in PyTorch's idiom: a ``torch.utils.data.DataLoader``
that collates with the dataset's own ``collate_fn``.

Training: ``EpochSampler`` (a copy of the reference's: a
``RandomState(epoch)`` permutation, then the rank stride) orders each
epoch, and ``EpochBatchSampler`` cuts that order into ``batch_size``
slices, dropping the last short one where ``drop_last`` is set, as the
reference's ``DataLoader.__len__`` / ``_batches``.  The training loader
of data-parallel rank ``rank`` of ``world`` (the train CLI's ranks) takes
batches ``k * world + rank`` of that one-rank order, ``len // world`` of
them an epoch: the batches that ``tools/train.py`` stacks for device
``rank`` of its mesh, the trailing remainder dropped.  (``EpochSampler``'s
own ``rank::world`` sample stride is another grouping; the loader leaves it
at one rank.)  A batch is loaded,
collated and passed through ``post`` in one worker process (the train
CLI's ``post`` pads it into a ``SceneBatch`` of CPU tensors and builds its
host pyramid there), so the main process only waits for it, pins it and
copies it to the card.

Augmentation draws: a worker's dataset ``rng`` is reseeded when the worker
starts, from ``SeedSequence([seed, epoch, worker id])`` (``seed``: the
dataset's, or where it has none the worker's own torch seed), so no two
workers and no two epochs repeat a draw.  The reference's process pool
pickles the parent's never-advanced ``rng`` into every batch, whose draws
then repeat batch after batch.  At ``num_workers=0`` every draw comes from
the dataset's own ``rng`` in the sampler's order, as the reference's.  A
data-parallel rank ``r > 0`` draws apart: its dataset ``rng`` (where the
dataset has a seed) is reseeded from ``SeedSequence([seed, r])`` and its
workers' from ``[seed, epoch, worker id, r]``; the reference's one process
draws for every device's batch from one ``rng`` in turn.

Test mode: batch 1, the scans in the dataset's order.
"""

from __future__ import annotations

import numpy as np
import torch

from .custom import CustomDataset
from .kitti import KITTIDataset
from .s3dis import S3DISDataset
from .scannetv2 import ScanNetDataset
from .stpls3d import STPLS3DDataset

DATASETS = {
    'scannetv2': ScanNetDataset,
    's3dis': S3DISDataset,
    'stpls3d': STPLS3DDataset,
    'kitti': KITTIDataset,
}


def build_dataset(cfg, logger=None) -> CustomDataset:
    """The dataset of a config's ``data.train`` / ``data.test`` section
    (its ``type`` picks the class, the other keys are its arguments)."""
    cfg = dict(cfg)
    dtype = cfg.pop('type')
    if dtype not in DATASETS:
        raise ValueError(f'unknown dataset type {dtype}')
    return DATASETS[dtype](logger=logger, **cfg)


class EpochSampler:
    """Deterministic per-epoch shuffling and rank sharding, the semantics
    of torch's DistributedSampler (shuffle and drop_last for training)."""

    def __init__(self, n: int, rank: int = 0, world: int = 1,
                 shuffle: bool = True, drop_last: bool = False):
        self.n = n
        self.rank = rank
        self.world = world
        self.shuffle = shuffle
        self.drop_last = drop_last

    def indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            idx = np.random.RandomState(epoch).permutation(self.n)
        if self.world > 1:
            if self.drop_last:
                per = self.n // self.world
                idx = idx[:per * self.world]
            else:
                pad = (-len(idx)) % self.world
                idx = np.concatenate([idx, idx[:pad]])
            idx = idx[self.rank::self.world]
        return idx


class EpochBatchSampler(torch.utils.data.Sampler):
    """The batches of the epoch set by ``set_epoch``: ``EpochSampler``'s
    indices in ``batch_size`` slices."""

    def __init__(self, sampler: EpochSampler, batch_size: int,
                 rank: int = 0, world: int = 1):
        self.sampler = sampler
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.sampler.indices(0))
        if self.sampler.drop_last:
            n_batches = n // self.batch_size
        else:
            n_batches = (n + self.batch_size - 1) // self.batch_size
        return n_batches // self.world

    def __iter__(self):
        idx = self.sampler.indices(self.epoch)
        bs = self.batch_size
        for k in range(len(self)):
            b = k * self.world + self.rank
            yield idx[b * bs:(b + 1) * bs].tolist()


class _Collate:
    """The dataset's ``collate_fn``, then ``post`` (run in the worker)."""

    def __init__(self, collate, post):
        self.collate, self.post = collate, post

    def __call__(self, samples):
        batch = self.collate(samples)
        return self.post(batch) if self.post else batch


def _rank_seed(entropy: list, rank: int) -> np.random.RandomState:
    """A ``RandomState`` from ``entropy``, with ``rank`` appended where it
    is not 0 (rank 0 draws as one process does)."""
    return np.random.RandomState(np.random.SeedSequence(
        entropy + ([rank] if rank else [])).generate_state(4))


class _SeedWorker:
    """``worker_init_fn``: reseeds the worker's dataset ``rng`` from
    (the dataset's seed, the epoch, the worker id, the data-parallel rank
    where not 0)."""

    def __init__(self, rank: int = 0):
        self.epoch = 0
        self.rank = rank

    def __call__(self, worker_id: int):
        info = torch.utils.data.get_worker_info()
        ds = info.dataset
        seed = ds.seed if ds.seed is not None else info.seed
        ds.rng = _rank_seed([seed, self.epoch, worker_id], self.rank)


class EpochLoader(torch.utils.data.DataLoader):
    """The training loader: a ``DataLoader`` over ``EpochBatchSampler``
    (shuffled, the last short batch dropped) whose epoch is set by
    ``set_epoch``; each batch is the dataset's collated dict, or what
    ``post`` makes of it.  ``rank`` / ``world``: the data-parallel rank's
    share of the batches (see the module docstring)."""

    def __init__(self, dataset: CustomDataset, batch_size: int = 1,
                 num_workers: int = 0, rank: int = 0, world: int = 1,
                 post=None, pin_memory: bool = False):
        workers = num_workers > 0
        if rank and dataset.seed is not None:
            dataset.rng = _rank_seed([dataset.seed], rank)
        super().__init__(
            dataset,
            batch_sampler=EpochBatchSampler(
                EpochSampler(len(dataset), shuffle=True, drop_last=True),
                batch_size, rank, world),
            num_workers=num_workers,
            collate_fn=_Collate(dataset.collate_fn, post),
            worker_init_fn=_SeedWorker(rank) if workers else None,
            # workers start from a fresh import: no fork of a process
            # that holds the card and threads
            multiprocessing_context='spawn' if workers else None,
            pin_memory=pin_memory)

    def set_epoch(self, epoch: int):
        self.batch_sampler.epoch = epoch
        if self.worker_init_fn is not None:
            self.worker_init_fn.epoch = epoch


def build_dataloader(dataset: CustomDataset, batch_size: int = 1,
                     num_workers: int = 0, training: bool = True,
                     rank: int = 0, world: int = 1, post=None,
                     pin_memory: bool = False):
    """The loader of ``dataset``, read by ``num_workers`` worker processes
    (0: in this process).

    Training (``training=True``): an ``EpochLoader`` that shuffles and
    drops the last short batch, giving data-parallel rank ``rank`` of
    ``world`` its batches, applying ``post`` to each collated batch in its
    worker and pinning the result where ``pin_memory`` is set.  Test: one
    collated scan a batch, in the dataset's order."""
    if training:
        return EpochLoader(dataset, batch_size, num_workers, rank, world,
                           post=post, pin_memory=pin_memory)
    assert batch_size == 1, 'test mode requires batch_size 1'
    return torch.utils.data.DataLoader(
        dataset, batch_size=1, shuffle=False, num_workers=num_workers,
        collate_fn=dataset.collate_fn)
