"""ScanNet v2 dataset (20 semantic / 18 instance classes, NYU id mapping,
instance-class shift of -2): a copy of ``softgroup_tpu/data/scannetv2.py``."""

from __future__ import annotations

import numpy as np
import torch

from .custom import CustomDataset


class ScanNetDataset(CustomDataset):

    CLASSES = ('cabinet', 'bed', 'chair', 'sofa', 'table', 'door', 'window',
               'bookshelf', 'picture', 'counter', 'desk', 'curtain',
               'refrigerator', 'shower curtain', 'toilet', 'sink', 'bathtub',
               'otherfurniture')
    NYU_ID = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)

    def load(self, filename):
        data = torch.load(filename, weights_only=False)
        if self.with_label:
            return data
        xyz, rgb = data
        dummy = np.zeros(xyz.shape[0], np.float32)
        return xyz, rgb, dummy, dummy.copy()

    def label_shift(self, instance_cls):
        # the first two semantic classes (wall, floor) are not instance
        # classes
        return np.where(instance_cls != -100, instance_cls - 2, instance_cls)
