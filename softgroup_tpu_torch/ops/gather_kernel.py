"""K2: row gather ``out[i] = src[clamp(idx[i], 0, len(src) - 1)]``.

Replaces ``softgroup_tpu/ops/gather_kernel.py:_gather_kernel`` (driven by
``monotone_row_gather`` / ``monotone_gather_f32``).  On the main path it
carries devoxelize (voxel features back to points), the grouping entry
gather and the cell-label gather, plus the proposal-entry gather of
``clusters_voxelization``.  Kernel source and design note:
``csrc/gather.cu``.  The copy moves raw bytes, so it is exact for every
dtype and needs no monotone indices.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it takes the plain version below.
"""

from __future__ import annotations

import torch

from . import kernels


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (clamped indices, as JAX gathers clamp)."""
    return src[idx.long().clamp(0, src.shape[0] - 1)]


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``src`` (any dtype, any trailing shape) at ``idx``."""
    if src.device.type == 'cpu':
        return row_gather_plain(src, idx)
    if src.shape[0] == 0:
        raise ValueError('row_gather: empty source')
    src = src.contiguous()
    idx = idx.to(torch.int32).contiguous()
    kernels.require_cuda('row_gather', src, idx)
    out = torch.empty((idx.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    row_bytes = src[0].numel() * src.element_size()
    rc = kernels.lib('gather').sg_row_gather(
        src.data_ptr(), idx.data_ptr(), src.shape[0], idx.shape[0],
        row_bytes, out.data_ptr(), kernels.stream())
    kernels.check(rc, 'row_gather')
    row_gather.launches += 1
    return out


row_gather.launches = 0
