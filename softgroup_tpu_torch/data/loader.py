"""Dataset registry and loader (counterpart of ``softgroup_tpu/data/
__init__.py``'s ``build_dataset`` / ``build_dataloader`` and of
``data/loader.py``), in PyTorch's idiom: a ``torch.utils.data.DataLoader``
that collates with the dataset's own ``collate_fn``.

Test mode only: batch 1, the scans in the dataset's order, as the
reference's loader gives them.  Its training sampler (``EpochSampler``: a
``RandomState(epoch)`` shuffle and a rank stride) waits for the
training-data slice.
"""

from __future__ import annotations

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


def build_dataloader(dataset: CustomDataset, batch_size: int = 1,
                     num_workers: int = 0, training: bool = True):
    """The test loader of ``dataset``: one collated scan a batch, in the
    dataset's order, read by ``num_workers`` worker processes (0: in this
    process)."""
    if training:
        raise NotImplementedError(
            'the training loader (a per-epoch shuffled, rank-strided '
            'sampler) waits for the training-data slice')
    assert batch_size == 1, 'test mode requires batch_size 1'
    return torch.utils.data.DataLoader(
        dataset, batch_size=1, shuffle=False, num_workers=num_workers,
        collate_fn=dataset.collate_fn)
