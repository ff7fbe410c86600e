"""Host-side assembly of static-shape batches (counterpart of
``softgroup_tpu/data/padding.py``: ``build_scene_batch``,
``round_capacity``).

The host voxelizes, builds the rulebook pyramid, averages the input
features per voxel, sorts points by voxel and pads everything to the static
capacities; the result is a ``SceneBatch`` of tensors on ``device``.  The
arrays equal the reference's exactly (the reference additionally attaches
TPU window metadata, which has no counterpart here).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..model.softgroup import Capacities, SceneBatch
from ..ops.geometry import HostGeometry, host_geometry


def round_capacity(n: int, granularity: float = 2 ** 0.5,
                   minimum: int = 1024) -> int:
    """Round up to the next power-of-sqrt(2) bucket, as a multiple of 256:
    scenes of similar size share one set of capacities."""
    n = max(n, minimum)
    b = granularity ** math.ceil(math.log(n, granularity))
    return int(math.ceil(b / 256) * 256)


def pad_to(arr: np.ndarray, cap: int, fill) -> np.ndarray:
    out = np.full((cap,) + arr.shape[1:], fill, arr.dtype)
    out[:len(arr)] = arr
    return out


def build_scene_batch(coords: np.ndarray, coords_float: np.ndarray,
                      feats: np.ndarray, semantic_labels: np.ndarray,
                      instance_labels: np.ndarray,
                      pt_offset_labels: np.ndarray,
                      instance_pointnum: np.ndarray,
                      instance_cls: np.ndarray, spatial_shape: np.ndarray,
                      caps: Capacities, num_levels: int,
                      ignore_label: int = -100,
                      batch_idxs: np.ndarray | None = None,
                      with_coords: bool = True,
                      device: str | torch.device = 'cuda',
                      geometry: HostGeometry | None = None) -> SceneBatch:
    """Pad a collated numpy batch into a SceneBatch with its pyramid.

    coords: (N, 4) int (batch, x, y, z) voxel coords (scaled, >= 0);
    spatial_shape: (3,) level-0 grid extent; batch_idxs: grouping batch ids
    (default coords[:, 0]); geometry: the pyramid of ``coords`` built
    already (``ops.geometry.host_geometry``), else built here with the
    native builders.
    """
    if batch_idxs is None:
        batch_idxs = coords[:, 0]
    n = len(coords)
    if n > caps.points:
        raise ValueError(f"{n} points exceed capacity {caps.points}")
    if geometry is None:
        geometry = host_geometry(coords, spatial_shape, num_levels)
    pyramid = geometry.padded(caps.voxels)
    p2v = pyramid.p2v.numpy()

    # voxel-mean network input ([colors || coords_float] per with_coords)
    fin = feats.astype(np.float32)
    if with_coords:
        fin = np.concatenate([fin, coords_float.astype(np.float32)], axis=1)
    cap0 = caps.voxels[0]
    cnt = np.bincount(p2v, minlength=cap0).astype(np.float32)[:cap0]
    vox_in = np.empty((cap0, fin.shape[1]), np.float32)
    denom = np.maximum(cnt, 1.0)
    for c in range(fin.shape[1]):
        vox_in[:, c] = np.bincount(p2v, weights=fin[:, c],
                                   minlength=cap0)[:cap0] / denom

    # sort points by level-0 voxel (p2v non-decreasing); point_perm maps a
    # row back to its original index
    order = np.argsort(p2v, kind='stable').astype(np.int32)
    p2v = p2v[order]
    coords_float = np.asarray(coords_float)[order]
    feats = np.asarray(feats)[order]
    batch_idxs = np.asarray(batch_idxs)[order]
    semantic_labels = np.asarray(semantic_labels)[order]
    instance_labels = np.asarray(instance_labels)[order]
    pt_offset_labels = np.asarray(pt_offset_labels)[order]
    point_perm = np.arange(caps.points, dtype=np.int32)
    point_perm[:n] = order

    # pad p2v with the capacity: pad rows drop out of voxel means
    p2v = pad_to(p2v, caps.points, cap0)
    point_valid = np.zeros((caps.points,), bool)
    point_valid[:n] = True

    ni = len(instance_pointnum)
    if ni > caps.instances:
        raise ValueError(f"{ni} instances exceed {caps.instances}")
    inst_valid = np.zeros((caps.instances,), bool)
    inst_valid[:ni] = True

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    pyramid.p2v = torch.from_numpy(p2v)
    pyramid.point_valid = torch.from_numpy(point_valid)
    return SceneBatch(
        pyramid=pyramid.to(device),
        feats=t(pad_to(feats.astype(np.float32), caps.points, 0.0)),
        coords_float=t(pad_to(coords_float.astype(np.float32), caps.points,
                              0.0)),
        batch_idxs=t(pad_to(np.asarray(batch_idxs).astype(np.int32),
                            caps.points, 0)),
        semantic_labels=t(pad_to(semantic_labels.astype(np.int32),
                                 caps.points, ignore_label)),
        instance_labels=t(pad_to(instance_labels.astype(np.int32),
                                 caps.points, ignore_label)),
        pt_offset_labels=t(pad_to(pt_offset_labels.astype(np.float32),
                                  caps.points, 0.0)),
        instance_pointnum=t(pad_to(instance_pointnum.astype(np.int32),
                                   caps.instances, 0)),
        instance_cls=t(pad_to(instance_cls.astype(np.int32), caps.instances,
                              ignore_label)),
        instance_valid=t(inst_valid),
        vox_in=t(vox_in),
        point_perm=t(point_perm),
    )
