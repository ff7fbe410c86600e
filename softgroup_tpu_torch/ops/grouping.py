"""Soft grouping: connected components of offset-shifted points through a
grid-cell contraction (counterpart of ``softgroup_tpu/ops/grouping.py``,
``cell_cluster_csr`` / ``_cell_core``).

1. bucket entries into cells of size radius * cell_scale, the group
   (batch x class) folded into one linear key ((g*d0 + x)*d1 + y)*d2 + z;
   one stable sort carries the payload and coordinates with the key.
   ``pair_keys=False`` (the ScanNet configs) keeps it in int32, as the
   reference does; ``pair_keys=True`` (every other config) computes it in
   int64.  The reference's pair of int32 keys (hi = g*d0 + x, lo = y*d2 +
   z; the TPU has no int64) sorts in the order of hi*(d1*d2) + lo, which
   is this int64 key since lo < d1*d2: the same cells, order and labels,
   at extents where groups * d0*d1*d2 passes 2^31;
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

``ball_cluster`` (``grouping_cfg.exact_ball_query``) is the point-level
alternative: connected components of the radius graph over a truncated
candidate list, labelled by the minimum entry index (the reference's
``ball_cluster``).  Its reverse-adjacency table and verification scatter
round are TPU workarounds for slow scatters: here a ``scatter_reduce``
(amin) over both directions of each edge, run to its fixpoint, gives the
same labels.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..util.trace import count
from .gather_kernel import row_gather
from .join_kernel import cell_neighbor_join
from .voxelize import compact_ascending

INT_MAX = 2 ** 31 - 1


def key_dtype(pair_keys: bool) -> torch.dtype:
    """The cell keys' type: int64 where the reference keeps pairs of
    int32 keys, else int32."""
    return torch.int64 if pair_keys else torch.int32


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


def ball_cluster(shifted: torch.Tensor, group: torch.Tensor,
                 valid: torch.Tensor, radius: float,
                 neighbors_per_cell: int = 4, own_window: int = 4,
                 max_rounds: int = 256) -> torch.Tensor:
    """Connected components of the radius graph, per group.

    The candidate graph: entries bucketed into cells of edge ``radius``
    under one int64 key ((group*d0 + x)*d1 + y)*d2 + z (the reference's
    pair key (group*d0 + x, y*d2 + z) in one word), sorted by (key, index);
    each entry takes the ``own_window`` entries before it in its own cell
    and the first ``neighbors_per_cell`` entries of each of the 26 adjacent
    cells, and keeps those within ``radius`` (d^2 <= r^2 in f32).  That
    truncation is the reference's, so dense blobs give its labels.

    Args:
      shifted: (N, 3) f32 entry coordinates; group: (N,) int group id;
        valid: (N,) bool; radius: the connection radius.
    Returns:
      (N,) int32: the minimum entry index of the entry's component, -1 for
      an invalid entry.  Raises where the propagation has not reached its
      fixpoint after ``max_rounds`` rounds.
    """
    n = shifted.shape[0]
    dev = shifted.device
    idxs = torch.arange(n, device=dev)
    r = float(np.float32(radius))
    inf = torch.full_like(shifted, math.inf)
    mn = torch.where(valid[:, None], shifted, inf).amin(dim=0)
    mn = torch.where(torch.isfinite(mn), mn, torch.zeros_like(mn))
    cell = torch.floor((shifted - mn[None, :]) / r).to(torch.int32)
    cell = cell.clamp(min=0)
    dims = torch.where(valid[:, None], cell, 0).amax(dim=0) + 2    # (3,)
    key_max = torch.iinfo(torch.int64).max
    ck, dk = cell.long(), dims.long()
    key = ((group.long() * dk[0] + ck[:, 0]) * dk[1] + ck[:, 1]) * dk[2] \
        + ck[:, 2]
    key = torch.where(valid, key, key_max)
    key_s, order = torch.sort(key, stable=True)
    pos = torch.empty_like(order)
    pos[order] = idxs
    first = (key_s != key_max) & (key_s != torch.cat(
        [key_s.new_full((1,), -1), key_s[:-1]]))
    run_start = torch.cummax(torch.where(first, idxs, -1), dim=0).values

    # (a) the own cell: the own_window entries before it in sorted order
    p_own = pos[:, None] - torch.arange(1, own_window + 1, device=dev)
    ok_own = valid[:, None] & (p_own >= run_start[pos][:, None])
    own = torch.where(ok_own, order[p_own.clamp(0, n - 1)], -1)
    # (b) the first neighbors_per_cell entries of each adjacent cell, found
    # by a search of the sorted keys (the axis checks keep each query key
    # that of the neighbouring cell)
    offs = torch.tensor(offsets(1), dtype=torch.int64, device=dev)  # (26, 3)
    ok_axis = valid[None, :] & torch.where(
        offs[:, None, :] < 0, (ck > 0)[None], True).all(-1) & torch.where(
        offs[:, None, :] > 0, (ck + 1 < dk)[None], True).all(-1)  # (26, N)
    d_key = (offs[:, 0] * dk[1] + offs[:, 1]) * dk[2] + offs[:, 2]
    q = torch.where(ok_axis, key[None, :] + d_key[:, None], key_max)
    hit = torch.searchsorted(key_s, q)                              # (26, N)
    p_nb = hit[:, :, None] + torch.arange(neighbors_per_cell, device=dev)
    pc_nb = p_nb.clamp(max=n - 1)
    ok_nb = ok_axis[:, :, None] & (p_nb < n) & (key_s[pc_nb] == q[:, :, None])
    nb = torch.where(ok_nb, order[pc_nb], -1)                       # (26,N,J)
    cand = torch.cat([own, nb.permute(1, 0, 2).reshape(n, -1)], dim=1)

    # the exact distance check
    ci = cand.clamp(min=0)
    other = row_gather(shifted, ci.reshape(-1)).reshape(n, -1, 3)
    d = shifted[:, None, :] - other
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    ok = (cand >= 0) & valid[:, None] & valid[ci] \
        & (d2 <= float(np.float32(r) * np.float32(r)))
    src = idxs[:, None].expand_as(cand)[ok]
    dst = cand[ok]

    # components of the undirected graph: min-label propagation over both
    # directions of each edge, with pointer jumping, to its fixpoint
    lab = torch.where(valid, idxs, n)
    for _ in range(max_rounds):
        new = lab.scatter_reduce(0, dst, lab[src], reduce='amin')
        new = new.scatter_reduce(0, src, lab[dst], reduce='amin')
        for _ in range(6):
            new = torch.minimum(new, new[new.clamp(max=n - 1)])
        count('grouping.rounds')
        if torch.equal(new, lab):       # one host read a round
            break
        lab = new
    else:
        raise RuntimeError(f'ball_cluster: labels still changing after '
                           f'{max_rounds} rounds')
    return torch.where(valid, lab, -1).to(torch.int32)


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
      pair_keys: int64 cell keys (True) or int32 (False).
    Returns:
      (ent_label, payload_s): (N,) int32 in sorted-entry order; ent_label is
      the component id in cell-index space, -1 for invalid, dropped or
      below-threshold entries.
    """
    n = shifted.shape[0]
    m = m_cap or n
    core = _cell_core(shifted, group, valid, payload.to(torch.int32),
                      radius, cell_scale, max_rounds, m,
                      key_dtype(pair_keys))
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
               max_rounds, m, kdt):
    """Bucket, sort (carrying ``payload``), build per-cell tables, join
    neighbour cells, propagate labels, on cell keys of type ``kdt`` (int32
    or int64; every factor is cast before the products).  Returns
    sorted-space and cell-space tensors."""
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
    key_max = torch.iinfo(kdt).max
    ck, dk = cell.to(kdt), dims.to(kdt)
    lo = (((group.to(kdt) * dk[0] + ck[:, 0]) * dk[1] + ck[:, 1]) * dk[2]
          + ck[:, 2])
    lo = torch.where(valid, lo, key_max)

    lo_s, order = torch.sort(lo, stable=True)
    payload_s = payload[order]
    pts_s = shifted[order]                                         # (N, 3)
    valid_s = lo_s != key_max
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
    clo = torch.where(cell_valid, lo_s[fpc], key_max)
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
        count('grouping.rounds')
        changed = bool((new != lab).any())      # one host read a round
        lab = new
        if not changed:
            break

    cell_group = torch.where(cell_valid, clo // (dk[0] * dk[1] * dk[2]), 0)
    # n_cells: every cell of the entries, also those past the cap m
    return dict(payload_s=payload_s, cid_s=cid_s, clab=lab, cnt=cnt,
                cell_valid=cell_valid, cell_group=cell_group,
                n_cells=n_cells)
