"""SemanticKITTI panoptic dataset: a copy of ``softgroup_tpu/data/kitti.py``.

Raw ``.bin`` / ``.label`` pairs under ``sequences/NN/velodyne`` and
``sequences/NN/labels``, the splits and label maps from the dataset's
``semantic-kitti.yaml`` beside them.  Semantic ids are remapped through the
yaml's learning_map so that stuff takes 0..10 and things 11..18 (0, the
unlabeled class, becomes -100); the instance classes shift by -11; the
training elastic distortion runs at 1/5 scale.
"""

from __future__ import annotations

import os.path as osp
from glob import glob
from pathlib import Path

import numpy as np
import yaml

from .custom import CustomDataset
from .transforms import augment_xyz, crop_to_size, elastic_distort


class KITTIDataset(CustomDataset):

    STUFF = ('road', 'parking', 'sidewalk', 'otherground', 'building',
             'fence', 'vegetation', 'trunk', 'terrain', 'pole',
             'traffic-sign')
    THING = ('car', 'bicycle', 'motorcycle', 'truck', 'other-vehicle',
             'person', 'bicyclist', 'motorcyclist')
    CLASSES = THING

    def __init__(self, data_root, prefix, suffix, voxel_cfg=None,
                 training=True, with_label=True, repeat=1, logger=None,
                 seed=None):
        with open(osp.join(data_root, 'semantic-kitti.yaml')) as f:
            meta = yaml.safe_load(f)
        split_key = {'train': 'train', 'val': 'valid', 'test': 'test'}[prefix]
        self.split = meta['split'][split_key]
        # the yaml's classes 1..8 are things, 9..19 stuff: stuff -> 0..10,
        # things -> 11..18, 0 -> ignore
        raw_map = meta['learning_map']
        self.learning_map = np.full(max(raw_map) + 1, -100, np.int64)
        for k, v in raw_map.items():
            self.learning_map[k] = -100 if v == 0 else (v + 10 if v < 9
                                                        else v - 9)
        # the yaml's own inverse (keys 1..19), read by the panoptic result
        # writer (tools_impl/test_cli.save_panoptic)
        self.learning_map_inv = meta['learning_map_inv']
        super().__init__(data_root, prefix, suffix, voxel_cfg, training,
                         with_label, repeat, logger, seed)

    def get_filenames(self):
        filenames = []
        for p in self.split:
            fns = glob(osp.join(self.data_root, 'sequences', f'{p:02d}',
                                'velodyne', '*' + self.suffix))
            assert len(fns) > 0, f'Empty {p}'
            filenames.extend(fns)
        return sorted(filenames * self.repeat)

    def load(self, filename):
        """(xyz, remission (n, 1), semantic, instance) of one scan: the
        label's low 16 bits are the raw semantic id; stuff carries no
        instance."""
        data = np.fromfile(filename, dtype=np.float32).reshape(-1, 4)
        xyz, remission = data[:, :3], data[:, 3:]
        if self.with_label:
            raw = np.fromfile(
                filename.replace('velodyne', 'labels').replace('bin', 'label'),
                dtype=np.int32)
            sem = self.learning_map[raw & 0xFFFF]
            inst = raw.copy()
            inst[sem <= 10] = -100
        else:
            sem = np.zeros(len(xyz), np.int64)
            inst = np.zeros(len(xyz), np.int64)
        return xyz, remission, sem, inst

    def label_shift(self, instance_cls):
        return np.where(instance_cls != -100, instance_cls - 11, instance_cls)

    def transform_train(self, xyz, rgb, semantic_label, instance_label,
                        aug_prob=1.0):
        rng = self.rng
        xyz_middle = augment_xyz(xyz, rng, jitter=True, flip=True, rot=True,
                                 scale=True, prob=aug_prob)
        # elastic distortion at 1/5 of the voxel scale
        down = 5
        xyz_scaled = xyz_middle * self.voxel_cfg.scale / down
        if rng.rand() < aug_prob:
            xyz_scaled = elastic_distort(xyz_scaled, 6, 40.0 / down, rng)
            xyz_scaled = elastic_distort(xyz_scaled, 20, 160.0 / down, rng)
        xyz_scaled = xyz_scaled * down
        xyz_scaled = xyz_scaled - xyz_scaled.min(0)
        valid = None
        for _ in range(5):
            xyz_offset, valid = crop_to_size(
                xyz_scaled, self.voxel_cfg.max_npoint,
                self.voxel_cfg.spatial_shape[1], rng)
            if valid.sum() >= self.voxel_cfg.min_npoint:
                xyz_scaled = xyz_offset
                break
        if valid is None or valid.sum() < self.voxel_cfg.min_npoint:
            return None
        inst = self._relabel_sparse_ids(instance_label[valid])
        return (xyz_scaled[valid], xyz_middle[valid], rgb[valid],
                semantic_label[valid], inst)

    def transform_test(self, xyz, rgb, semantic_label, instance_label):
        xyz_middle = augment_xyz(xyz, self.rng)
        xyz_scaled = xyz_middle * self.voxel_cfg.scale
        xyz_scaled = xyz_scaled - xyz_scaled.min(0)
        inst = self._relabel_sparse_ids(instance_label)
        return xyz_scaled, xyz_middle, rgb, semantic_label, inst

    @staticmethod
    def _relabel_sparse_ids(instance_label):
        """Raw instance ids are sparse 32-bit values: compact them to
        0..K-1 in ascending order, keeping -100."""
        ids = np.unique(instance_label)
        ids = ids[ids != -100]
        out = np.full_like(instance_label, -100)
        for new, old in enumerate(ids):
            out[instance_label == old] = new
        return out

    def __getitem__(self, index):
        """The base item, with the scan id scoped by its sequence
        (``sequences/08/velodyne/000000``)."""
        item = super().__getitem__(index)
        if item is None:
            return None
        parts = Path(self.filenames[index]).parts[-4:]
        item['scan_id'] = osp.join(*parts).replace(self.suffix, '')
        return item
