"""Voxelization: dedup integer coords and map voxel features back to points (counterpart of
``softgroup_tpu/ops/voxelize.py``).

``voxelize_np`` is the host route for the input batch; ``voxelize_linear``
runs on the device for the proposal grids of ``clusters_voxelization``;
``voxel_features`` averages point features per voxel (the SoftGroup++
path's voxel coordinates, and the network input of a batch without
``vox_in``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .gather_kernel import gather_rows
from .segment import segment_mean

INT_MAX = 2 ** 31 - 1


class Voxelized(NamedTuple):
    """Static-capacity voxelization: vox_coords (cap, 4) int32 (0 past
    n_voxels), vox_valid (cap,) bool, p2v (N,) int32 (cap for invalid or
    overflowing points), n_voxels () int."""
    vox_coords: torch.Tensor
    vox_valid: torch.Tensor
    p2v: torch.Tensor
    n_voxels: torch.Tensor


def compact_ascending(mask: torch.Tensor, n_out: int, fill: int):
    """Ascending indices of True entries, truncated or padded with ``fill``
    to ``n_out`` — what the reference gets from its top_k trick
    (``_compact_ascending``)."""
    idx = torch.nonzero(mask).reshape(-1)[:n_out].to(torch.int32)
    if idx.shape[0] < n_out:
        idx = torch.cat([idx, idx.new_full((n_out - idx.shape[0],), fill)])
    return idx


def voxelize_linear(coords: torch.Tensor, valid: torch.Tensor, dims,
                    capacity: int):
    """Device voxelization on int32 linear keys ((b*d0 + x)*d1 + y)*d2 + z.

    Returns (Voxelized, sorted unique keys (capacity,) int32, INT_MAX
    padded) — the key table the keyed conv (K4) resolves neighbours in."""
    c = coords.to(torch.int32)
    d0, d1, d2 = (int(x) for x in dims)
    key = ((c[:, 0] * d0 + c[:, 1]) * d1 + c[:, 2]) * d2 + c[:, 3]
    key = torch.where(valid, key, INT_MAX)
    n = key.shape[0]
    key_s, order = torch.sort(key, stable=True)
    valid_s = key_s != INT_MAX
    prev = torch.cat([key_s.new_full((1,), -1), key_s[:-1]])
    first = valid_s & (key_s != prev)
    uid_s = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    n_unique = (uid_s[-1] + 1).clamp(min=0)
    uid_s = torch.where(valid_s & (uid_s < capacity), uid_s, capacity)
    fpos = compact_ascending(first, capacity, n)
    uniq_valid = fpos < n
    fpos_c = fpos.clamp(0, n - 1).long()
    rep = order[fpos_c]
    vox_coords = torch.where(uniq_valid[:, None], c[rep], 0).to(torch.int32)
    ckey = torch.where(uniq_valid, key_s[fpos_c], INT_MAX)
    p2v = torch.empty_like(uid_s)
    p2v[order] = uid_s
    p2v = torch.where(valid, p2v, capacity)
    return Voxelized(vox_coords, uniq_valid, p2v, n_unique), ckey


def voxel_features(point_feats: torch.Tensor, p2v: torch.Tensor,
                   capacity: int) -> torch.Tensor:
    """Mean point features per voxel (empty voxels 0).  Rows whose p2v is
    ``capacity`` or more (pad points) fall into the dustbin segment and drop
    out of every mean."""
    return segment_mean(point_feats, p2v, capacity)


def devoxelize(vox_feats: torch.Tensor, p2v: torch.Tensor) -> torch.Tensor:
    """Voxel features back to points, ``vox_feats[clamp(p2v)]`` (K2);
    out-of-range p2v (pad points) read the last row and are masked by the
    callers.

    ``build_scene_batch`` sorts points by voxel and pads p2v with the
    capacity, so the clamped p2v is non-decreasing and the backward (the
    gather's transpose) goes straight to the sorted segment sum (K6); this
    is asserted on the device."""
    if torch.is_grad_enabled() and vox_feats.requires_grad:
        torch._assert_async((p2v[1:] >= p2v[:-1]).all(),
                            'devoxelize: p2v must be non-decreasing')
    return gather_rows(vox_feats, p2v, sorted_idx=True)


def voxelize_np(coords: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host voxelization with exact shapes: (N, 4) int coords (b, x, y, z)
    -> vox_coords (M, 4) int32 in sorted key order, p2v (N,) int32,
    counts (M,) int32."""
    coords = np.asarray(coords)
    key = ((coords[:, 0].astype(np.int64) << 48)
           | (coords[:, 1].astype(np.int64) << 32)
           | (coords[:, 2].astype(np.int64) << 16)
           | coords[:, 3].astype(np.int64))
    uniq, p2v, counts = np.unique(key, return_inverse=True, return_counts=True)
    first = np.zeros(len(uniq), dtype=np.int64)
    first[p2v[::-1]] = np.arange(len(coords) - 1, -1, -1)
    vox_coords = coords[first].astype(np.int32)
    return vox_coords, p2v.astype(np.int32), counts.astype(np.int32)
