"""parallel of the PyTorch/CUDA port (see the package docstring): data
parallelism over ``torch.distributed`` (``ddp.py``)."""

from .ddp import (all_reduce_mean, average_step, check_devices,
                  collect_results, free_port, init_dist, norm_buffers,
                  replica_max_diff)

__all__ = ['all_reduce_mean', 'average_step', 'check_devices',
           'collect_results', 'free_port', 'init_dist', 'norm_buffers',
           'replica_max_diff']
