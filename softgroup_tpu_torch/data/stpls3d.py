"""STPLS3D aerial dataset (15 semantic / 14 instance classes, shift -1): a
copy of ``softgroup_tpu/data/stpls3d.py``."""

from __future__ import annotations

import numpy as np

from .custom import CustomDataset


class STPLS3DDataset(CustomDataset):

    CLASSES = ('building', 'low vegetation', 'med. vegetation',
               'high vegetation', 'vehicle', 'truck', 'aircraft',
               'militaryVehicle', 'bike', 'motorcycle', 'light pole',
               'street sign', 'clutter', 'fence')

    def label_shift(self, instance_cls):
        # class 0 (ground) carries no instances
        return np.where(instance_cls != -100, instance_cls - 1, instance_cls)
