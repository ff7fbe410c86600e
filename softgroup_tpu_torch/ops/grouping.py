"""Soft grouping: connected components of offset-shifted points through a
grid-cell contraction (counterpart of ``softgroup_tpu/ops/grouping.py``,
``cell_cluster_csr`` / ``_cell_core`` on single int32 linear keys,
``pair_keys=False``).

1. bucket entries into cells of size radius * cell_scale, the group
   (batch x class) folded into the linear key; one stable sort carries the
   payload and coordinates with the key;
2. per-cell tables (first/last entry, count, centroid by f64 cumsum difference)
   over the sorted order, capped at ``m`` cells;
3. neighbour cells whose centroids lie within the radius: the join kernel
   K3 (``join_kernel.cell_neighbor_join``);
4. min-label propagation with pointer jumping, at most ``max_rounds``
   rounds;
5. component-size threshold per class at cell level, and one label gather
   per sorted entry (K2).

The reference's top_k compaction, sparse-table reductions and bf16x3 splits
are TPU cost workarounds; ``torch.nonzero`` and plain indexing compute the
same values.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .gather_kernel import row_gather
from .join_kernel import cell_neighbor_join
from .voxelize import compact_ascending

INT_MAX = 2 ** 31 - 1


@functools.lru_cache(maxsize=None)
def offsets(reach: int) -> np.ndarray:
    """The (R, 3) int32 neighbour offsets within ``reach`` cells, centre
    left out, in ascending (dx, dy, dz) order; built once per reach (a
    read-only array shared by every call)."""
    r = range(-reach, reach + 1)
    a = np.array([[x, y, z] for x in r for y in r for z in r
                  if (x, y, z) != (0, 0, 0)], np.int32)
    a.flags.writeable = False
    return a


def cell_cluster_csr(shifted: torch.Tensor, group: torch.Tensor,
                     valid: torch.Tensor, payload: torch.Tensor,
                     thr_of_group: torch.Tensor, radius: float,
                     cell_scale: float = 0.5, max_rounds: int = 96,
                     m_cap: int | None = None, pair_keys: bool = True):
    """Cluster entries and threshold component sizes, in sorted-entry space.

    Args:
      shifted: (N, 3) f32 entry coordinates; group: (N,) int group id
        (batch * n_classes + class); valid: (N,) bool; payload: (N,) int
        carried through the sort; thr_of_group: (n_classes,) f32 minimum
        component size per class (looked up as group % n_classes).
    Returns:
      (ent_label, payload_s): (N,) int32 in sorted-entry order; ent_label is
      the component id in cell-index space, -1 for invalid, dropped or
      below-threshold entries.
    """
    if pair_keys:
        raise NotImplementedError(
            'pair_keys=True grouping (ops/keys.py in the reference) is not '
            'ported yet; set grouping_cfg.pair_keys=False')
    n = shifted.shape[0]
    m = m_cap or n
    core = _cell_core(shifted, group, valid, payload.to(torch.int32),
                      radius, cell_scale, max_rounds, m)
    clab, cnt, cell_valid = core['clab'], core['cnt'], core['cell_valid']
    sizes = cnt.new_zeros((m + 1,)).index_add_(0, clab.long().clamp(0, m),
                                               cnt)
    comp_size = sizes[clab.long().clamp(0, m - 1)]
    thr_cell = thr_of_group[(core['cell_group'] % thr_of_group.shape[0])
                            .long()]
    lab_cell = torch.where(cell_valid & (clab >= 0) & (clab < m)
                           & (comp_size >= thr_cell), clab, -1)
    tab = torch.cat([lab_cell, lab_cell.new_full((1,), -1)])
    cid_s = core['cid_s']
    ok_e = cid_s < m
    last_cid = torch.where(ok_e, cid_s, 0).max()
    cid_g = torch.minimum(cid_s, last_cid)
    ent_label = torch.where(ok_e, row_gather(tab, cid_g), -1)
    return ent_label.to(torch.int32), core['payload_s']


def _cell_core(shifted, group, valid, payload, radius, cell_scale,
               max_rounds, m):
    """Bucket, sort (carrying ``payload``), build per-cell tables, join
    neighbour cells, propagate labels.  Returns sorted-space and cell-space
    tensors."""
    n = shifted.shape[0]
    dev = shifted.device
    s = float(np.float32(radius) * np.float32(cell_scale))
    reach = int(math.ceil(1.0 / cell_scale))

    inf = torch.full_like(shifted, math.inf)
    mn = torch.where(valid[:, None], shifted, inf).amin(dim=0)
    mn = torch.where(torch.isfinite(mn), mn, torch.zeros_like(mn))
    cell = torch.floor((shifted - mn[None, :]) / s).to(torch.int32)
    cell = cell.clamp(min=0)
    dims = torch.where(valid[:, None], cell, 0).amax(dim=0) + 2   # (3,)
    lo = (((group.to(torch.int32) * dims[0] + cell[:, 0]) * dims[1]
           + cell[:, 1]) * dims[2] + cell[:, 2])
    lo = torch.where(valid, lo, INT_MAX)

    lo_s, order = torch.sort(lo, stable=True)
    payload_s = payload[order]
    pts_s = shifted[order]                                         # (N, 3)
    valid_s = lo_s != INT_MAX
    prev_lo = torch.cat([lo_s.new_full((1,), -1), lo_s[:-1]])
    first = valid_s & (lo_s != prev_lo)
    cid_s = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    n_cells = (cid_s[-1] + 1).clamp(min=0)
    n_valid = valid_s.sum().to(torch.int32)
    cid_s = torch.where(valid_s & (cid_s < m), cid_s, m)

    fp = compact_ascending(first, m, INT_MAX)
    arange_m = torch.arange(m, dtype=torch.int32, device=dev)
    n_cells_m = n_cells.clamp(max=m)
    cell_valid = (fp < n) & (arange_m < n_cells_m)
    fpc = fp.clamp(max=n - 1).long()
    clo = torch.where(cell_valid, lo_s[fpc], INT_MAX)
    lp = torch.cat([fpc[1:], fpc.new_zeros((1,))])
    lp = torch.where(arange_m == n_cells_m - 1, n_valid.long(),
                     torch.where(cell_valid, lp, 1)) - 1
    lpc = lp.clamp(0, n - 1)
    cnt = torch.where(cell_valid, lp - fpc + 1, 0).to(torch.float32)
    # centroids by cumsum difference over the sorted coordinates, as the
    # reference computes them, but summed in f64: an f32 running sum of
    # ~1e5 entries reaches ~1e5 m, where one rounding is ~0.008 m against a
    # 0.04 m radius, so the f32 result depends on the summation order (the
    # CPU's and the card's differ).  Where the f32 sums are exact (inputs on
    # a coarse binary grid) both give the same centroids.
    # (scanned along the inner dim: PyTorch's outer-dim scan of an (N, 3)
    # tensor is ~500x slower on the card)
    cums = torch.cumsum(pts_s.double().T.contiguous(), dim=1).T
    before = torch.where((fpc > 0)[:, None], cums[(fpc - 1).clamp(min=0)],
                         torch.zeros_like(cums[:1]))
    seg_sum = (cums[lpc] - before).float()
    centroid = seg_sum / cnt.clamp(min=1.0)[:, None]
    ccoord = torch.floor((pts_s[fpc] - mn[None, :]) / s).to(torch.int32)
    ccoord = ccoord.clamp(min=0)

    cand = cell_neighbor_join(clo, centroid, ccoord, dims.to(torch.int32),
                              offsets(reach), radius).T            # (m, R)
    cand_c = cand.long().clamp(0, m - 1)
    cand_ok = cand >= 0

    lab = torch.where(cell_valid, arange_m, m)
    big = torch.full_like(cand, m)
    for _ in range(max_rounds):
        cl = torch.where(cand_ok, lab[cand_c], big)
        new = torch.minimum(lab, cl.amin(dim=1))
        for _ in range(4):   # pointer jumping
            new = torch.minimum(new, new[new.long().clamp(0, m - 1)])
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            break

    cell_group = torch.where(cell_valid,
                             clo // (dims[0] * dims[1] * dims[2]), 0)
    return dict(payload_s=payload_s, cid_s=cid_s, clab=lab, cnt=cnt, cell_valid=cell_valid,
                cell_group=cell_group)
