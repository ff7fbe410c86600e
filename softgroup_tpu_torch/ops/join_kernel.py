"""K3, the neighbour-cell join of soft grouping, and K7, the rulebook join
of the training proposal grids.

Replaces ``softgroup_tpu/ops/join_kernel.py:_join_kernel`` (driven by
``cell_neighbor_join``), called from ``grouping._cell_core`` on
``pair_keys=False`` configs.  A thread of K3 takes a cell and a run of
offsets (one (dx, dy), rising dz), searches the run's first key in the rows
that unique keys leave for it and steps forward for the rest (design note:
``csrc/join.cu``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it takes the plain version below, which follows the reference's XLA path
(searchsorted join, then the centroid gate, ``ops/grouping.py:275-288``).

K7 ``sorted_key_rules_join`` replaces ``join_kernel.py:_rules_kernel``
(driven by ``sorted_key_rules_join``), called from
``rulebook.build_subm_rules_linear`` for every tiny-U-Net level of the
training step; its plain version is the reference's ``xla_rules_join``.
A block of K7 takes a tile of rows, stages the one key window its queries
can hit and searches it in shared memory (design note: ``csrc/join.cu``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels

INT_MAX = 2 ** 31 - 1
# K7's rows a block (32, 64, 128 or 256; each block stages the key window
# of its tile's queries); None, as the package leaves it: the largest that
# leaves _K7_MIN_BLOCKS blocks (64 at m = 131072, 32 at m = 32768).  Only
# the tile sweep (time_kernels --k7-tile) and the card tests set it, to
# reach the tiles the path's sizes do not pick.
_K7_TILE = None
_K7_MIN_BLOCKS = 2048
_K7_MAX_OFFSETS = 64   # csrc/join.cu RJ_MAX_OFF
# K3's threads a block (32, 64, 128 or 256); None, as the package leaves
# it: 64, the fastest at both of the path's sizes.  Only the block sweep
# (time_kernels --k3-block) and the card tests set it.
_K3_BLOCK = None
_K3_MAX_OFFSETS = 128   # csrc/join.cu CJ_MAX_OFF


def radius_sq(radius: float) -> float:
    """radius * radius in f32, as the reference squares its f32 radius."""
    r = np.float32(radius)
    return float(r * r)


def _d_lin(offs_t: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    """Linear key offset of each (dx, dy, dz) offset on a ``dims`` grid."""
    return (offs_t[:, 0] * dims[1] + offs_t[:, 1]) * dims[2] + offs_t[:, 2]


def cell_neighbor_join_plain(table_keys, centroid, ccoord, dims, offs,
                             radius) -> torch.Tensor:
    """(R, m) int32: see ``cell_neighbor_join``."""
    m = table_keys.shape[0]
    dev = table_keys.device
    offs_t = torch.tensor(np.asarray(offs, np.int32), device=dev)
    dims = dims.to(torch.int32)
    ct = ccoord.T[None]                                  # (1, 3, m)
    ok = ((table_keys != INT_MAX)[None, :]
          & (offs_t[:, :, None] + ct >= 0).all(dim=1)
          & (offs_t[:, :, None] <= dims[None, :, None] - 1 - ct).all(dim=1))
    q = torch.where(ok, table_keys[None, :] + _d_lin(offs_t, dims)[:, None],
                    torch.full_like(table_keys, INT_MAX)[None, :])
    pos = torch.searchsorted(table_keys, q.reshape(-1)).reshape(q.shape)
    pc = pos.clamp(0, m - 1)
    hit = ok & (pos < m) & (table_keys[pc] == q)
    # squared distance in the kernel's order: (dx*dx + dy*dy) + dz*dz
    dx = centroid[:, 0][None, :] - centroid[:, 0][pc]
    dy = centroid[:, 1][None, :] - centroid[:, 1][pc]
    dz = centroid[:, 2][None, :] - centroid[:, 2][pc]
    d2 = (dx * dx + dy * dy) + dz * dz
    keep = hit & (d2 <= radius_sq(radius))
    return torch.where(keep, pc, -1).to(torch.int32)


def cell_neighbor_join(table_keys: torch.Tensor, centroid: torch.Tensor,
                       ccoord: torch.Tensor, dims: torch.Tensor, offs,
                       radius: float,
                       stats: torch.Tensor | None = None) -> torch.Tensor:
    """cand[r, i] = j with table_keys[j] == table_keys[i] + dlin(r), the
    bounds test ``0 <= ccoord[i] + offs[r] < dims`` passed, and
    ``|centroid[i] - centroid[j]|^2 <= radius^2``; else -1.

    table_keys: (m,) int32 linear cell keys ((x*dims1 + y)*dims2 + z, the
    group folded into x), sorted, unique among valid rows, INT_MAX padded.
    centroid (m, 3) f32; ccoord (m, 3) int32; dims (3,) int32 tensor (stays
    on the device: no host sync); offs (R, 3) integer offsets.
    Returns (R, m) int32, exact.  ``stats``: an optional zeroed (2,) int32
    tensor on the card that the kernel fills with the widest bracket it
    searched and the count of queries it searched for over the whole table
    (duplicate keys, or a sum beyond int32; the census of
    ``time_kernels``).
    """
    if table_keys.device.type == 'cpu':
        return cell_neighbor_join_plain(table_keys, centroid, ccoord, dims,
                                        offs, radius)
    dev = table_keys.device
    keys, cen, cc, dm = (_as(t, d) for t, d in (
        (table_keys, torch.int32), (centroid, torch.float32),
        (ccoord, torch.int32), (dims, torch.int32)))
    kernels.require_cuda('cell_neighbor_join', keys, cen, cc, dm,
                         *(() if stats is None else (stats,)))
    _check_stats('cell_neighbor_join', stats)
    plan = _k3_plan(offs)
    m = keys.shape[0]
    out = torch.empty((int(plan[0]), m), dtype=torch.int32, device=dev)
    rc = kernels.entry('join', 'sg_cell_join')(
        keys.data_ptr(), cen.data_ptr(), cc.data_ptr(), dm.data_ptr(),
        plan.ctypes.data, m, radius_sq(radius),
        _K3_BLOCK or 64, out.data_ptr(),
        None if stats is None else stats.data_ptr(), kernels.stream(dev))
    kernels.check(rc, 'cell_neighbor_join')
    cell_neighbor_join.launches += 1
    return out


cell_neighbor_join.launches = 0


def sorted_key_rules_join_plain(table_keys, xyz, dims, offs) -> torch.Tensor:
    """(R, m) int32: see ``sorted_key_rules_join`` (the reference's
    ``xla_rules_join`` with ``torch.searchsorted``)."""
    m = table_keys.shape[0]
    offs_t = torch.as_tensor(np.asarray(offs, np.int32),
                             device=table_keys.device)
    dims = dims.to(torch.int32)
    xt = xyz.T[None]                                      # (1, 3, m)
    ok = ((table_keys != INT_MAX)[None, :]
          & (offs_t[:, :, None] + xt >= 0).all(dim=1)
          & (offs_t[:, :, None] <= dims[None, :, None] - 1 - xt).all(dim=1))
    q = torch.where(ok, table_keys[None, :] + _d_lin(offs_t, dims)[:, None],
                    torch.full_like(table_keys, INT_MAX)[None, :])
    pos = torch.searchsorted(table_keys, q.reshape(-1)).reshape(q.shape)
    pc = pos.clamp(0, m - 1)
    hit = ok & (pos < m) & (table_keys[pc] == q)
    return torch.where(hit, pc, -1).to(torch.int32)


_offsets_on: dict = {}


def _k7_tile(m: int) -> int:
    """K7's rows a block for an m-row table: ``_K7_TILE`` if set, else the
    largest of 256, 128, 64, 32 that leaves ``_K7_MIN_BLOCKS`` blocks (32
    at least)."""
    if _K7_TILE is not None:
        return _K7_TILE
    tile = 256
    while tile > 32 and m // tile < _K7_MIN_BLOCKS:
        tile //= 2
    return tile


def _device_offsets(offs, dev: torch.device) -> torch.Tensor:
    """``offs`` as an (R, 3) int32 tensor on ``dev``, copied there once per
    offset set (a copy a call costs K7 a host-to-device transfer)."""
    a = np.ascontiguousarray(np.asarray(offs, np.int32))
    key = (a.tobytes(), a.shape, dev)
    t = _offsets_on.get(key)
    if t is None:
        t = _offsets_on[key] = torch.tensor(a, device=dev)
    return t


_plans: dict = {}


def _k3_plan(offs) -> np.ndarray:
    """K3's launch plan for the offsets ``offs`` (``CellJoinPlan`` of
    ``csrc/join.cu``, passed to the kernel by value), built once per offset
    set: int32 [R, number of runs, the (R, 3) offsets padded to 128 rows,
    the runs' first offsets and R].  A run is a stretch of consecutive
    offsets with one (dx, dy) and rising dz (9 of the 26 offsets within
    one cell)."""
    a = np.ascontiguousarray(np.asarray(offs, np.int32)).reshape(-1, 3)
    key = a.tobytes()
    plan = _plans.get(key)
    if plan is None:
        n = len(a)
        if n > _K3_MAX_OFFSETS:
            raise ValueError(f'cell_neighbor_join: at most '
                             f'{_K3_MAX_OFFSETS} offsets, got {n}')
        starts = [0] + [k for k in range(1, n)
                        if a[k, 0] != a[k - 1, 0] or a[k, 1] != a[k - 1, 1]
                        or a[k, 2] <= a[k - 1, 2]]
        plan = np.zeros(2 + 4 * _K3_MAX_OFFSETS + 1, np.int32)
        plan[:2] = n, len(starts)
        plan[2:2 + 3 * n] = a.reshape(-1)
        runs = 2 + 3 * _K3_MAX_OFFSETS
        plan[runs:runs + len(starts) + 1] = starts + [n]
        plan = _plans[key] = plan
    return plan


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous tensor of ``dtype`` (itself where it is one:
    ``.to`` and ``.contiguous`` cost microseconds of host time even then)."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def _check_stats(what: str, stats: torch.Tensor | None) -> None:
    if stats is not None and (stats.dtype != torch.int32
                              or stats.numel() < 2):
        raise ValueError(f'{what}: stats must be (2,) int32')


def sorted_key_rules_join(table_keys: torch.Tensor, xyz: torch.Tensor,
                          dims: torch.Tensor, offs,
                          stats: torch.Tensor | None = None) -> torch.Tensor:
    """K7: rules[r, i] = j with table_keys[j] == table_keys[i] + dlin(r)
    and the bounds test ``0 <= xyz[i] + offs[r] < dims`` passed, else -1.

    table_keys: (m,) int32 sorted linear keys ((b*d0 + x)*d1 + y)*d2 + z,
    INT_MAX padded; xyz (m, 3) int32 voxel coords; dims (3,) int32 tensor
    (stays on the device); offs (R, 3) integer offsets.  Returns (R, m)
    int32, exact.  ``stats``: an optional zeroed (2,) int32 tensor on the
    card that the kernel fills with its largest key window and the count of
    queries it searched for in the table beyond the staged part (the
    census of ``time_kernels``)."""
    if table_keys.device.type == 'cpu':
        return sorted_key_rules_join_plain(table_keys, xyz, dims, offs)
    dev = table_keys.device
    keys = table_keys.to(torch.int32).contiguous()
    xyz = xyz.to(torch.int32).contiguous()
    dm = dims.to(torch.int32).contiguous()
    offs_t = _device_offsets(offs, dev)
    kernels.require_cuda('sorted_key_rules_join', keys, xyz, dm, offs_t,
                         *(() if stats is None else (stats,)))
    _check_stats('sorted_key_rules_join', stats)
    m, n_off = keys.shape[0], offs_t.shape[0]
    if n_off > _K7_MAX_OFFSETS:
        raise ValueError(f'sorted_key_rules_join: at most {_K7_MAX_OFFSETS} '
                         f'offsets, got {n_off}')
    out = torch.empty((n_off, m), dtype=torch.int32, device=dev)
    rc = kernels.entry('join', 'sg_rules_join')(
        keys.data_ptr(), xyz.data_ptr(), dm.data_ptr(), offs_t.data_ptr(),
        n_off, m, _k7_tile(m), out.data_ptr(),
        None if stats is None else stats.data_ptr(), kernels.stream(dev))
    kernels.check(rc, 'sorted_key_rules_join')
    sorted_key_rules_join.launches += 1
    return out


sorted_key_rules_join.launches = 0
