"""Base dataset: prepared ``.pth`` scans, augmented, cropped and collated
into numpy batches (a copy of ``softgroup_tpu/data/custom.py``, itself the
pipeline of the reference's ``softgroup/data/custom.py``: transform_train
:138-160, transform_test :162-168, __getitem__ :170-189, collate
:191-256).  A collated batch goes to ``data.padding.build_scene_batch``
(the runner's ``build_batch``), which voxelizes, builds the pyramid and
pads it to static capacities.
"""

from __future__ import annotations

import os.path as osp
from glob import glob

import numpy as np
import torch

from .synthetic import instance_info
from .transforms import (augment_xyz, crop_to_size, elastic_distort,
                         relabel_instances)


class CustomDataset:

    CLASSES: tuple = ()
    NYU_ID = None
    CROP_STEP = 32  # crop window shrink step (S3DIS overrides to 64)

    def __init__(self, data_root, prefix, suffix, voxel_cfg=None,
                 training=True, with_label=True, repeat=1, logger=None,
                 seed=None):
        self.data_root = data_root
        self.prefix = prefix
        self.suffix = suffix
        self.voxel_cfg = voxel_cfg
        self.training = training
        self.with_label = with_label
        self.repeat = repeat
        self.logger = logger
        # every augmentation draws from rng; a loader worker reseeds it
        # from seed (data/loader.py)
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.mode = 'train' if training else 'test'
        self.filenames = self.get_filenames()
        if self.logger:
            self.logger.info(
                f'Load {self.mode} dataset: {len(self.filenames)} scans')

    def get_filenames(self):
        filenames = glob(
            osp.join(self.data_root, self.prefix, '*' + self.suffix))
        assert len(filenames) > 0, 'Empty dataset.'
        return sorted(filenames * self.repeat)

    def load(self, filename):
        # prepared scans are torch pickles of numpy arrays
        return torch.load(filename, weights_only=False)

    def __len__(self):
        return len(self.filenames)

    # -------- per-scan transforms --------

    def label_shift(self, instance_cls: np.ndarray) -> np.ndarray:
        """Map semantic class of each instance to the 0-based instance-class
        range (dataset-specific; e.g. -2 for ScanNet)."""
        return instance_cls

    def transform_train(self, xyz, rgb, semantic_label, instance_label,
                        aug_prob=1.0):
        rng = self.rng
        xyz_middle = augment_xyz(xyz, rng, jitter=True, flip=True, rot=True,
                                 prob=aug_prob)
        xyz_scaled = xyz_middle * self.voxel_cfg.scale
        if rng.rand() < aug_prob:
            xyz_scaled = elastic_distort(xyz_scaled, 6, 40.0, rng)
            xyz_scaled = elastic_distort(xyz_scaled, 20, 160.0, rng)
        xyz_scaled = xyz_scaled - xyz_scaled.min(0)
        valid = None
        for _ in range(5):
            xyz_offset, valid = crop_to_size(
                xyz_scaled, self.voxel_cfg.max_npoint,
                self.voxel_cfg.spatial_shape[1], rng, step=self.CROP_STEP)
            if valid.sum() >= self.voxel_cfg.min_npoint:
                xyz_scaled = xyz_offset
                break
        if valid is None or valid.sum() < self.voxel_cfg.min_npoint:
            return None
        xyz_scaled = xyz_scaled[valid]
        xyz_middle = xyz_middle[valid]
        rgb = rgb[valid]
        semantic_label = semantic_label[valid]
        instance_label = relabel_instances(instance_label, valid)
        return xyz_scaled, xyz_middle, rgb, semantic_label, instance_label

    def transform_test(self, xyz, rgb, semantic_label, instance_label):
        xyz_middle = augment_xyz(xyz, self.rng)
        xyz_scaled = xyz_middle * self.voxel_cfg.scale
        xyz_scaled = xyz_scaled - xyz_scaled.min(0)
        instance_label = relabel_instances(
            instance_label, np.ones(len(xyz), bool))
        return xyz_scaled, xyz_middle, rgb, semantic_label, instance_label

    def __getitem__(self, index):
        filename = self.filenames[index]
        scan_id = osp.basename(filename).replace(self.suffix, '')
        xyz, rgb, sem, inst = self.load(filename)
        # prepared .pth files store labels as float64 (the reference's
        # prepare_data_inst.py format); integer label ops need int
        data = (np.asarray(xyz), np.asarray(rgb),
                np.asarray(sem).astype(np.int64),
                np.asarray(inst).astype(np.int64))
        data = self.transform_train(*data) if self.training \
            else self.transform_test(*data)
        if data is None:
            return None
        xyz_scaled, xyz_middle, rgb, semantic_label, instance_label = data
        inst = instance_label.astype(np.int32)
        n_inst, pointnum, inst_cls, offsets = instance_info(
            xyz_middle, inst, semantic_label)
        inst_cls = self.label_shift(inst_cls)
        feat = rgb.astype(np.float32)
        if self.training:
            feat = feat + self.rng.randn(1, feat.shape[1]).astype(
                np.float32) * 0.1
        return dict(
            scan_id=scan_id,
            coord=np.floor(xyz_scaled).astype(np.int64),
            coord_float=xyz_middle.astype(np.float32),
            feat=feat,
            semantic_label=semantic_label.astype(np.int64),
            instance_label=inst,
            inst_num=n_inst,
            inst_pointnum=pointnum,
            inst_cls=inst_cls,
            pt_offset_label=offsets.astype(np.float32),
        )

    # -------- batching --------

    def collate_fn(self, samples: list) -> dict:
        samples = [s for s in samples if s is not None]
        assert len(samples) > 0, 'empty batch'
        coords, coords_float, feats = [], [], []
        sems, insts, offs, pointnum, icls, scan_ids = [], [], [], [], [], []
        total_inst = 0
        for b, s in enumerate(samples):
            inst = s['instance_label']
            inst = np.where(inst >= 0, inst + total_inst, inst)
            total_inst += s['inst_num']
            c = np.concatenate(
                [np.full((len(inst), 1), b, np.int64), s['coord']], axis=1)
            coords.append(c)
            coords_float.append(s['coord_float'])
            feats.append(s['feat'])
            sems.append(s['semantic_label'])
            insts.append(inst)
            offs.append(s['pt_offset_label'])
            pointnum.append(s['inst_pointnum'])
            icls.append(s['inst_cls'])
            scan_ids.append(s['scan_id'])
        coords = np.concatenate(coords).astype(np.int32)
        spatial_shape = np.clip(coords[:, 1:].max(0) + 1,
                                self.voxel_cfg.spatial_shape[0], None)
        cat = (np.concatenate if total_inst else
               lambda xs: np.zeros((0,), np.int32))
        return dict(
            scan_ids=scan_ids,
            coords=coords,
            coords_float=np.concatenate(coords_float),
            feats=np.concatenate(feats),
            semantic_labels=np.concatenate(sems),
            instance_labels=np.concatenate(insts),
            pt_offset_labels=np.concatenate(offs),
            instance_pointnum=cat(pointnum),
            instance_cls=cat(icls),
            spatial_shape=spatial_shape,
            batch_size=len(samples),
        )
