"""data of the PyTorch/CUDA port (see the package docstring): the datasets
of the indoor configs and of SemanticKITTI, their training loader and their
test loader."""

from .custom import CustomDataset
from .kitti import KITTIDataset
from .loader import (DATASETS, EpochLoader, EpochSampler, build_dataloader,
                     build_dataset)
from .s3dis import S3DISDataset
from .scannetv2 import ScanNetDataset
from .stpls3d import STPLS3DDataset

__all__ = ['CustomDataset', 'DATASETS', 'EpochLoader', 'EpochSampler',
           'KITTIDataset', 'S3DISDataset', 'ScanNetDataset',
           'STPLS3DDataset', 'build_dataloader', 'build_dataset']
