"""data of the PyTorch/CUDA port (see the package docstring): the datasets
of the pair-key indoor configs and their test loader."""

from .custom import CustomDataset
from .loader import DATASETS, build_dataloader, build_dataset
from .s3dis import S3DISDataset
from .scannetv2 import ScanNetDataset
from .stpls3d import STPLS3DDataset

__all__ = ['CustomDataset', 'DATASETS', 'S3DISDataset', 'ScanNetDataset',
           'STPLS3DDataset', 'build_dataloader', 'build_dataset']
