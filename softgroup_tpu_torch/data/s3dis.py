"""S3DIS dataset (13 classes, multi-Area prefixes, the x4_split big-room
protocol): a copy of ``softgroup_tpu/data/s3dis.py``.

x4_split: a room is split into 4 interleaved point subsets (point i in part
i % 4), each voxelized as its own batch item through the backbone; grouping
sees one merged scene (``grouping_batch_idxs`` 0).  Training subsamples
1/4 of the points.
"""

from __future__ import annotations

import os.path as osp
from glob import glob

import numpy as np
import torch

from .custom import CustomDataset
from .transforms import augment_xyz, relabel_instances


class S3DISDataset(CustomDataset):

    CLASSES = ('ceiling', 'floor', 'wall', 'beam', 'column', 'window', 'door',
               'chair', 'table', 'bookcase', 'sofa', 'board', 'clutter')
    CROP_STEP = 64

    def __init__(self, x4_split=False, **kwargs):
        self.x4_split = x4_split
        super().__init__(**kwargs)

    def get_filenames(self):
        prefixes = ([self.prefix] if isinstance(self.prefix, str)
                    else list(self.prefix))
        filenames = []
        for p in prefixes:
            fns = glob(osp.join(self.data_root, p + '*' + self.suffix))
            assert len(fns) > 0, f'Empty {p}'
            filenames.extend(fns)
        return sorted(filenames * self.repeat)

    def load(self, filename):
        xyz, rgb, semantic_label, instance_label, *_ = torch.load(
            filename, weights_only=False)
        if self.training and self.x4_split:
            n = len(xyz)
            inds = self.rng.choice(n, int(n * 0.25), replace=False)
            xyz, rgb = xyz[inds], rgb[inds]
            semantic_label = semantic_label[inds]
            # prepared files store labels as float64: relabelling indexes
            # with the instance ids, so they are cast first (the reference
            # indexes with the floats and raises)
            instance_label = relabel_instances(
                np.asarray(instance_label).astype(np.int64), inds)
        return xyz, rgb, semantic_label, instance_label

    def transform_test(self, xyz, rgb, semantic_label, instance_label):
        """x4_split: the rows keep their order; part i % 4 becomes the
        voxel batch coordinate (``collate_fn``), each part's scaled
        coordinates start at 0 (per-part min subtraction, as the
        reference's split)."""
        if not self.x4_split:
            return super().transform_test(xyz, rgb, semantic_label,
                                          instance_label)
        n = len(xyz)
        part = np.arange(n) % 4
        xyz_middle = augment_xyz(xyz, self.rng)
        xyz_scaled = xyz_middle * self.voxel_cfg.scale
        for k in range(4):
            m = part == k
            xyz_scaled[m] -= xyz_scaled[m].min(0)
        instance_label = relabel_instances(instance_label, np.ones(n, bool))
        return xyz_scaled, xyz_middle, rgb, semantic_label, instance_label

    def __getitem__(self, index):
        item = super().__getitem__(index)
        if item is None or self.training or not self.x4_split:
            return item
        item['part'] = (np.arange(len(item['coord'])) % 4).astype(np.int64)
        return item

    def collate_fn(self, samples):
        batch = super().collate_fn(samples)
        if self.training or not self.x4_split:
            return batch
        # one scan: the voxel batch coordinate is the part id, grouping
        # sees one merged scene (batch_idxs 0)
        s = samples[0]
        batch['coords'][:, 0] = s['part']
        batch['grouping_batch_idxs'] = np.zeros(len(s['part']), np.int32)
        batch['x4_split'] = True
        return batch
