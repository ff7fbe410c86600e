"""Grid pyramid: the multi-level sparse geometry of one U-Net pass
(counterpart of ``softgroup_tpu/ops/geometry.py``).

Geometry depends only on coordinates, so the host builds the backbone
pyramid once per batch (C++ through ``ops/native.py``, or numpy) and the
network forward only gathers.
Level l is the U-Net recursion depth l: its voxels, the 3^3 rulebook shared
by every conv of the level, and the k2s2 maps to level l+1 and back.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence

import numpy as np
import torch

from . import native as _native
from .rulebook import build_downsample_np, build_subm_rules_np
from .sparse_conv import hit_orders
from .voxelize import voxelize_np


@dataclass
class LevelGeom:
    """Static-capacity geometry of one pyramid level.

    Two encodings of the neighbour structure: explicit rulebooks
    (``subm_rules`` / ``down_rules``, host-built for the backbone) or a
    sorted linear-key table (``ckey`` + ``spatial_d``, device-built for
    proposal grids; the keyed conv kernel resolves neighbours itself).
    ``subm_rows`` / ``subm_grouped``: the rulebook's row order
    (``sparse_conv.hit_orders``) that the submanifold convs run K1 on,
    built in the forward (``row_ordered``) before a U-Net takes the
    levels."""
    vox_coords: torch.Tensor            # (V, 4) int32
    vox_valid: torch.Tensor             # (V,) bool
    subm_rules: torch.Tensor | None     # (27, V) int32, -1 = missing
    down_rules: torch.Tensor | None     # (8, V_next) int32 into this level
    parent_idx: torch.Tensor | None     # (V,) int32 (V_next if invalid)
    child_tap: torch.Tensor | None      # (V,) int32 in [0, 8)
    dims: torch.Tensor                  # (3,) int32 spatial extent
    ckey: torch.Tensor | None = None    # (V,) sorted keys (keyed levels)
    spatial_d: int = 0
    subm_rows: torch.Tensor | None = None     # (V,) int32 row order
    subm_grouped: torch.Tensor | None = None  # (27, V) subm_rules[:, rows]

    def apply(self, fn) -> 'LevelGeom':
        """A copy with ``fn`` applied to each of its tensors."""
        return replace(self, **{
            k: fn(getattr(self, k)) for k in (
                'vox_coords', 'vox_valid', 'subm_rules', 'down_rules',
                'parent_idx', 'child_tap', 'dims', 'ckey', 'subm_rows',
                'subm_grouped')
            if getattr(self, k) is not None})


def row_ordered(levels: Sequence[LevelGeom]) -> tuple[LevelGeom, ...]:
    """The levels, each rulebook level with its row order
    (``sparse_conv.hit_orders``: one sort for them all, on the levels'
    device)."""
    out = list(levels)
    todo = [i for i, lv in enumerate(levels) if lv.subm_rules is not None]
    if todo:
        orders = hit_orders([levels[i].subm_rules for i in todo])
        for i, (rows, grouped) in zip(todo, orders):
            out[i] = replace(levels[i], subm_rows=rows, subm_grouped=grouped)
    return tuple(out)


@dataclass
class Pyramid:
    levels: tuple[LevelGeom, ...]
    p2v: torch.Tensor            # (P,) int32 point -> level-0 voxel (cap: pad)
    point_valid: torch.Tensor    # (P,) bool

    def apply(self, fn) -> 'Pyramid':
        """A copy with ``fn`` applied to each of its tensors."""
        return Pyramid(tuple(lv.apply(fn) for lv in self.levels),
                       fn(self.p2v), fn(self.point_valid))

    def to(self, device) -> 'Pyramid':
        return self.apply(lambda t: t.to(device))


@dataclass
class HostGeometry:
    """The unpadded host pyramid of one batch: per level (vox_coords,
    subm_rules, down_rules, parent_idx, child_tap, dims) as numpy arrays
    (the last level without the three down maps), and p2v."""
    levels: list[tuple]
    p2v: np.ndarray

    @property
    def counts(self) -> list[int]:
        """The voxel count of each level."""
        return [len(lv[0]) for lv in self.levels]

    def padded(self, capacities: Sequence[int] | None = None) -> Pyramid:
        """The pyramid as CPU tensors, every per-level array padded to its
        static capacity (``None``: to its own size)."""
        caps = self.counts if capacities is None else list(capacities)
        for lvl, (n, cap) in enumerate(zip(self.counts, caps)):
            if n > cap:
                raise ValueError(
                    f"level {lvl}: {n} voxels exceed capacity {cap}")
        levels = tuple(
            _pad_level(*lv[:5], caps[lvl],
                       caps[lvl + 1] if lvl + 1 < len(caps) else 0, lv[5])
            for lvl, lv in enumerate(self.levels))
        return Pyramid(
            levels=levels,
            p2v=torch.from_numpy(np.minimum(self.p2v, caps[0])
                                 .astype(np.int32)),
            point_valid=torch.ones((len(self.p2v),), dtype=torch.bool),
        )


def host_geometry(coords: np.ndarray, dims: np.ndarray, num_levels: int,
                  native: bool = True) -> HostGeometry:
    """Host pyramid builder at the batch's own sizes.

    ``native`` (the default) builds with the C++ library of
    ``ops/native.py`` (compiled at first use; a failed build raises);
    ``native=False`` takes the numpy builders, the plain version with the
    same outputs."""
    if native:
        vox_coords, p2v, _ = _native.voxelize_native(np.asarray(coords))
        subm_rules, downsample = (_native.subm_rules_native,
                                  _native.downsample_native)
    else:
        vox_coords, p2v, _ = voxelize_np(np.asarray(coords))
        subm_rules, downsample = build_subm_rules_np, build_downsample_np
    levels = []
    cur = vox_coords
    cur_dims = np.asarray(dims, np.int64)
    for lvl in range(num_levels):
        subm = subm_rules(cur, cur_dims)
        if lvl + 1 < num_levels:
            nxt, down_rules, parent_idx, child_tap = downsample(cur)
            levels.append((cur, subm, down_rules, parent_idx, child_tap,
                           cur_dims))
            cur = nxt
            cur_dims = (cur_dims + 1) // 2
        else:
            levels.append((cur, subm, None, None, None, cur_dims))
    return HostGeometry(levels, p2v)


def build_pyramid_np(coords: np.ndarray, dims: np.ndarray, num_levels: int,
                     capacities: Sequence[int] | None = None,
                     native: bool = True) -> Pyramid:
    """``host_geometry`` padded to ``capacities``.  Returns CPU tensors."""
    return host_geometry(coords, dims, num_levels, native).padded(capacities)


def _pad_level(vc, subm, down_rules, parent_idx, child_tap, cap, cap_next,
               dims) -> LevelGeom:
    m = len(vc)

    def pad2(a, cap1, fill):
        out = np.full((a.shape[0], cap1), fill, a.dtype)
        out[:, :a.shape[1]] = a
        return torch.from_numpy(out)

    def pad1(a, cap1, fill):
        out = np.full((cap1,), fill, a.dtype)
        out[:len(a)] = a
        return torch.from_numpy(out)

    vcp = np.zeros((cap, 4), np.int32)
    vcp[:m] = vc
    return LevelGeom(
        vox_coords=torch.from_numpy(vcp),
        vox_valid=torch.from_numpy(np.arange(cap) < m),
        subm_rules=pad2(subm, cap, -1),
        down_rules=None if down_rules is None
        else pad2(down_rules, cap_next, -1),
        parent_idx=None if parent_idx is None else pad1(
            parent_idx.astype(np.int32), cap, cap_next),
        child_tap=None if child_tap is None else pad1(child_tap, cap, 0),
        dims=torch.from_numpy(np.asarray(dims, np.int32)),
    )
