"""Rulebook construction (counterpart of ``softgroup_tpu/ops/rulebook.py``):
the host (numpy) route for the backbone pyramid (``build_subm_rules_np`` /
``build_downsample_np``) and the device linear-key route for the training
proposal grids (``build_subm_rules_linear`` on K7 /
``build_downsample_linear``), each with the reference's outputs.

A rulebook is a dense (K, V) int32 gather table: for output voxel v and
kernel tap k, the input voxel that feeds it, -1 if none.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .join_kernel import sorted_key_rules_join

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


# the 26 non-centre taps, in tap order
_NON_CENTER = tuple(map(tuple, np.delete(SUBM_OFFSETS, CENTER_TAP,
                                         axis=0).tolist()))


def build_subm_rules_linear(ckey: torch.Tensor, vox_coords: torch.Tensor,
                            vox_valid: torch.Tensor,
                            dims: torch.Tensor) -> torch.Tensor:
    """(27, V) int32 rulebook from a sorted linear key table (see
    ``voxelize.voxelize_linear``): K7's 26 joined taps plus the identity
    centre tap of the valid voxels."""
    v = ckey.shape[0]
    keys = torch.where(vox_valid, ckey, 2 ** 31 - 1).to(torch.int32)
    rules26 = sorted_key_rules_join(keys, vox_coords[:, 1:], dims,
                                    _NON_CENTER)
    ident = torch.where(vox_valid,
                        torch.arange(v, dtype=torch.int32, device=ckey.device),
                        -1)
    return torch.cat([rules26[:CENTER_TAP], ident[None],
                      rules26[CENTER_TAP:]]).to(torch.int32)


def build_downsample_linear(vox_coords: torch.Tensor,
                            vox_valid: torch.Tensor, dims, capacity: int):
    """The next (2x coarser) level on the device: (coarse coords (C, 4),
    coarse valid (C,), n_voxels, down_rules (8, C), parent_idx (V,),
    child_tap (V,), coarse sorted keys (C,), coarse dims).  ``dims``: the
    fine grid's extent as three ints (the coarse one is returned so)."""
    from .voxelize import voxelize_linear

    v = vox_coords.shape[0]
    xyz = vox_coords[:, 1:]
    parent_coords = torch.cat([vox_coords[:, :1], xyz // 2], dim=1)
    coarse_dims = tuple((int(d) + 1) // 2 for d in dims)
    vx, ckey = voxelize_linear(parent_coords, vox_valid, coarse_dims,
                               capacity)
    parent_idx = vx.p2v
    child_tap = ((xyz[:, 0] & 1) * 4 + (xyz[:, 1] & 1) * 2
                 + (xyz[:, 2] & 1)).to(torch.int32)
    flat = torch.where(vox_valid,
                       child_tap * (capacity + 1)
                       + parent_idx.clamp(max=capacity),
                       8 * (capacity + 1) - 1).long()
    down = torch.full((8 * (capacity + 1),), -1, dtype=torch.int32,
                      device=vox_coords.device)
    down[flat] = torch.where(
        vox_valid, torch.arange(v, dtype=torch.int32,
                                device=vox_coords.device), -1)
    down_rules = down.reshape(8, capacity + 1)[:, :capacity]
    return (vx.vox_coords, vx.vox_valid, vx.n_voxels, down_rules, parent_idx,
            child_tap, ckey, coarse_dims)
