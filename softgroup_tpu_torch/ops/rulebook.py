"""Host (numpy) rulebook construction for the backbone pyramid — the
numpy route of ``softgroup_tpu/ops/rulebook.py`` (``build_subm_rules_np`` /
``build_downsample_np``), with identical outputs.

A rulebook is a dense (K, V) int32 gather table: for output voxel v and
kernel tap k, the input voxel that feeds it, -1 if none.
"""

from __future__ import annotations

import itertools

import numpy as np

# kernel tap offsets for 3x3x3 submanifold conv, index = (dx+1)*9+(dy+1)*3+(dz+1)
SUBM_OFFSETS = np.array(
    list(itertools.product((-1, 0, 1), repeat=3)), dtype=np.int32)  # (27, 3)
CENTER_TAP = 13  # (0, 0, 0)

# child offsets for k=2 s=2 conv, index = dx*4+dy*2+dz
DOWN_OFFSETS = np.array(
    list(itertools.product((0, 1), repeat=3)), dtype=np.int32)  # (8, 3)


def _keys_np(coords: np.ndarray) -> np.ndarray:
    c = coords.astype(np.int64)
    return (c[:, 0] << 48) | (c[:, 1] << 32) | (c[:, 2] << 16) | c[:, 3]


def build_subm_rules_np(vox_coords: np.ndarray, dims: np.ndarray) -> np.ndarray:
    """(27, M) gather table, -1 for missing neighbours."""
    m = len(vox_coords)
    table = _keys_np(vox_coords)
    order = np.argsort(table)
    sorted_keys = table[order]
    rules = np.full((27, m), -1, np.int32)
    for k, off in enumerate(SUBM_OFFSETS):
        if k == CENTER_TAP:
            rules[k] = np.arange(m, dtype=np.int32)
            continue
        q = vox_coords.copy()
        q[:, 1:] += off
        in_range = ((q[:, 1:] >= 0) & (q[:, 1:] < dims)).all(axis=1)
        qk = _keys_np(q)
        pos = np.searchsorted(sorted_keys, qk)
        pos = np.clip(pos, 0, m - 1)
        hit = (sorted_keys[pos] == qk) & in_range
        rules[k] = np.where(hit, order[pos], -1).astype(np.int32)
    return rules


def build_downsample_np(vox_coords: np.ndarray):
    """Voxel set of the next (2x coarser) level and both-direction maps:
    (out_coords (C, 4), down_rules (8, C), parent_idx (M,), child_tap (M,))."""
    from .voxelize import voxelize_np

    parent_coords = vox_coords.copy()
    parent_coords[:, 1:] //= 2
    out_coords, parent_idx, _ = voxelize_np(parent_coords)
    c = len(out_coords)
    xyz = vox_coords[:, 1:]
    child_tap = ((xyz[:, 0] & 1) * 4 + (xyz[:, 1] & 1) * 2
                 + (xyz[:, 2] & 1)).astype(np.int32)
    down_rules = np.full((8, c), -1, np.int32)
    down_rules[child_tap, parent_idx] = np.arange(len(vox_coords), dtype=np.int32)
    return out_coords, down_rules, parent_idx, child_tap
