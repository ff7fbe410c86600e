"""Plain PyTorch reference of SoftGroup inference on an x4-split S3DIS
room: the backbone (``sparse_unet``, batch norms on their running
statistics), soft grouping by cell contraction, and the refinement head
(proposal grids, the tiny U-Net, the cls / iou / mask heads).

It imports nothing of the program.  It works out again, from the raw room
the benchmark made: the test transform (the fixed 0.35 pi rotation, four
interleaved parts, each part's grid from 0), the voxels and pyramid, the
order in which the program lists its points (sorted by level-0 voxel,
stably), the per-room capacities (the program's rule: sqrt(2) buckets),
the grouping cells and their links, the proposals, and the proposal
grids.

What it compares it computes from the program's own outputs where an
exact answer needs the same input: grouping runs on the program's
semantic scores and offsets (a score a rounding apart flips a point's
cell), refinement on the program's proposals; the backbone that feeds
both is compared on its own.

Grouping's rules, as the architecture states them with static capacities:
a point enters each non-ignored class whose softmax score passes
``score_thr`` and that has at least ``min_npoint`` such points (at most
``grouping_points`` entries, in point order, then by falling score);
entries fall into cells of edge ``radius`` per class; only the first
``grouping_cells`` cells in key order are kept; two neighbouring cells
(26-neighbourhood) link when their centroids lie within ``radius``;
labels spread over the links for at most 96 rounds of least-label
propagation with pointer jumping (``_labels``); a component is kept when
its entries reach ``npoint_thr`` x the class's mean size, and is labelled
by its smallest cell; proposals are the components in label order, at
most ``proposals`` of them and ``proposal_entries`` entries.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .sparse_unet import (Level, NoTF32, Precision, Scene,  # noqa: F401
                          _subm_pairs, batch_norm, build_levels, dense, mlp,
                          point_heads, unet)

INT_MAX = 2 ** 31 - 1
# cells kept for grouping by the inference runner (its capacities set no
# other number)
GROUPING_CELLS = 65536
# rounds of the cell-label propagation
MAX_ROUNDS = 96


# ---------------------------------------------------------------------------
# Input
# ---------------------------------------------------------------------------

def x4_scan(room, scale: float):
    """(c4 (N, 4) int64 part/x/y/z, coords (N, 3) f32, rgb (N, 3) f32) of
    a room under the x4-split test transform."""
    xyz, rgb = room[0], room[1]
    theta = 0.35 * np.pi
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(3) @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    middle = xyz @ m
    scaled = middle * scale
    part = np.arange(len(xyz)) % 4
    for k in range(4):
        scaled[part == k] -= scaled[part == k].min(0)
    c4 = np.concatenate([part[:, None], np.floor(scaled).astype(np.int64)],
                        1)
    return c4, middle.astype(np.float32), rgb.astype(np.float32)


def _round(n: int) -> int:
    """The next power-of-sqrt(2) bucket, as a multiple of 256."""
    b = (2 ** 0.5) ** math.ceil(math.log(n, 2 ** 0.5))
    return int(math.ceil(b / 256) * 256)


def capacities(n_points: int, base: dict) -> dict:
    """The per-room capacities that grouping and refinement truncate
    at: the runner's sqrt(2) buckets of the room's points, its base's
    proposals, entries and grid voxels."""
    rows = n_points
    return dict(
        grouping_points=_round(max(2 * rows, 8192)),
        proposals=base['proposals'],
        proposal_entries=min(_round(max(6 * rows, 8192)),
                             base['proposal_entries']),
        inst_voxels=tuple(base['inst_voxels']),
        grouping_cells=GROUPING_CELLS)


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------

def backbone(P: dict, room, scale: float, num_levels: int, device,
             prec: Precision):
    """(semantic scores, offsets, point features, coords, order) in the
    room's own point order; ``order[i]``: the room's point listed i-th by
    the program."""
    c4, coords, rgb = x4_scan(room, scale)
    c4_t = torch.as_tensor(c4, device=device)
    levels, p2v = build_levels(c4_t, num_levels)
    coords_t = torch.as_tensor(coords, device=device)
    feats = torch.cat([torch.as_tensor(rgb, device=device), coords_t], 1)
    v0 = levels[0].n
    cnt = torch.zeros(v0, dtype=torch.float64, device=device).index_add_(
        0, p2v, torch.ones_like(p2v, dtype=torch.float64))
    vox_in = (torch.zeros((v0, feats.shape[1]), dtype=torch.float64,
                          device=device).index_add_(0, p2v, feats.double())
              / cnt[:, None]).float()
    sc = Scene(levels, p2v, vox_in, coords_t, None, None, None)
    sem, off, f = point_heads(P, sc, prec, train=False)
    order = torch.sort(p2v, stable=True).indices
    return sem, off, f, coords_t, order


# ---------------------------------------------------------------------------
# Grouping
# ---------------------------------------------------------------------------

def _labels(n: int, src: torch.Tensor, dst: torch.Tensor,
            rounds: int = MAX_ROUNDS, jumps: int = 4):
    """Component labels of ``n`` cells linked by the edges ``src -> dst``:
    the architecture's bounded propagation, each round every cell taking
    the least label of itself and its links, then ``jumps`` pointer jumps,
    for at most ``rounds`` rounds (the smallest cell of its component once
    it has settled)."""
    lab = torch.arange(n, device=src.device)
    for _ in range(rounds):
        new = lab.scatter_reduce(0, src, lab[dst], reduce='amin')
        for _ in range(jumps):
            new = torch.minimum(new, new[new])
        if torch.equal(new, lab):
            break
        lab = new
    return lab


def grouping(sem, off, coords, model_cfg: dict, caps: dict,
             coord_dtype=torch.float32):
    """Proposals of the rows (program order): (entry_pt, entry_seg,
    entry_valid, n_proposals), ``proposal_entries`` long.
    ``coord_dtype``: the shifted coordinates' precision (float32, as
    stated; bfloat16 for the control)."""
    g = model_cfg['grouping_cfg']
    dev = sem.device
    n, n_cls = sem.shape
    thr = float(g['score_thr'])
    scores = torch.softmax(sem.float(), dim=-1)
    ignore = torch.zeros(n_cls, dtype=torch.bool, device=dev)
    ignore[list(g['ignore_classes'])] = True
    counts = ((scores > thr) & ~ignore[None, :]).sum(0)
    class_ok = (counts >= int(model_cfg['test_cfg']['min_npoint'])) & ~ignore
    k = min(n_cls, int(np.floor(1.0 / max(thr, 1e-6))) + 1)
    top_s, top_c = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s, top_c = top_s[:, :k], top_c[:, :k]
    cand = (top_s > thr) & class_ok[top_c]
    idx = torch.nonzero(cand.reshape(-1)).reshape(-1)[:caps['grouping_points']]
    pt = idx // k
    cls = top_c.reshape(-1)[idx]
    shifted = (coords + off.float())[pt].to(coord_dtype).float()
    group = cls      # one grouping scene: batch 0

    # cells of edge radius, keyed by (class, cell)
    r32 = np.float32(g['radius'])
    edge = float(r32 * np.float32(g.get('cell_scale', 1.0)))
    mn = shifted.amin(0)
    cell = torch.floor((shifted - mn[None, :]) / edge).to(torch.int32)
    cell = cell.clamp(min=0).long()
    dims = cell.amax(0) + 2
    key = ((group * dims[0] + cell[:, 0]) * dims[1] + cell[:, 1]) * dims[2] \
        + cell[:, 2]
    key_s, order = torch.sort(key, stable=True)
    pt_s, pts_s, cell_s = pt[order], shifted[order], cell[order]
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    rank = torch.cumsum(first.long(), 0) - 1
    fp = torch.nonzero(first).reshape(-1)
    m = min(len(fp), caps['grouping_cells'])
    last = torch.cat([fp[1:], fp.new_tensor([len(key_s)])]) - 1
    fp, last = fp[:m], last[:m]
    cnt = (last - fp + 1).float()
    # centroids: the f64 running sum of the sorted coordinates, differenced
    cums = torch.cumsum(pts_s.double().T.contiguous(), dim=1).T
    before = torch.where((fp > 0)[:, None], cums[(fp - 1).clamp(min=0)],
                         torch.zeros_like(cums[:1]))
    centroid = (cums[last] - before).float() / cnt[:, None]
    ckey, ccell = key_s[fp], cell_s[fp]

    # links between neighbouring kept cells within the radius
    r2 = float(r32 * r32)
    src, dst = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if dx == dy == dz == 0:
                    continue
                off3 = torch.tensor([dx, dy, dz], device=dev)
                inb = ((ccell + off3 >= 0) & (ccell + off3 < dims)).all(1)
                q = ckey + (dx * dims[1] + dy) * dims[2] + dz
                pos = torch.searchsorted(ckey, q).clamp(max=m - 1)
                hit = inb & (ckey[pos] == q)
                d = centroid - centroid[pos]
                d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
                ok = hit & (d2 <= r2)
                src.append(torch.nonzero(ok).reshape(-1))
                dst.append(pos[ok])
    clab = _labels(m, torch.cat(src), torch.cat(dst))
    size = torch.zeros(m, device=dev).index_add_(0, clab, cnt)[clab]
    mean = torch.tensor(g['class_numpoint_mean'], dtype=torch.float32,
                        device=dev)
    npoint_thr = float(g['npoint_thr'])
    thr_cls = torch.where(mean == -1.0, torch.full_like(mean, npoint_thr),
                          npoint_thr * mean)
    cell_cls = ckey // (dims[0] * dims[1] * dims[2])
    lab_cell = torch.where(size >= thr_cls[cell_cls], clab, -1)
    kept = rank < m
    ent_lab = torch.where(kept, lab_cell[rank.clamp(max=m - 1)], -1)

    # proposals: components in label order
    lab_key = torch.where(ent_lab >= 0, ent_lab, INT_MAX)
    lab_s, o2 = torch.sort(lab_key, stable=True)
    pt_p = pt_s[o2]
    valid = lab_s != INT_MAX
    new = valid.clone()
    new[1:] &= lab_s[1:] != lab_s[:-1]
    pid = torch.cumsum(new.long(), 0) - 1
    p_max, s_cap = caps['proposals'], caps['proposal_entries']
    n_prop = min(int(new.sum()), p_max)
    entry_valid = (valid & (pid < p_max))[:s_cap]
    entry_pt = pt_p[:s_cap]
    entry_seg = torch.where(entry_valid, pid[:s_cap], p_max)
    return entry_pt, entry_seg, entry_valid, n_prop


# ---------------------------------------------------------------------------
# Refinement
# ---------------------------------------------------------------------------

def _capped_unique(keys: torch.Tensor, cap: int):
    """(sorted unique keys, at most ``cap``; each key's rank, ``cap`` for
    a key past it)."""
    uniq, inv = torch.unique(keys, return_inverse=True)
    return uniq[:cap], torch.where(inv < cap, inv, cap)


def refine(P: dict, feats, coords, entry_pt, entry_seg, entry_valid,
           n_prop: int, caps: dict, model_cfg: dict, prec: Precision):
    """(cls scores (softmaxed), iou scores, mask scores) of the program's
    proposals: cls / iou for the first ``n_prop`` proposals, mask for the
    valid entries (in their order)."""
    dev = feats.device
    icfg = model_cfg['instance_voxel_cfg']
    d = int(icfg['spatial_shape'])
    p_max = caps['proposals']
    ept = entry_pt[entry_valid].long()
    seg = entry_seg[entry_valid].long()
    xyz, fe = coords[ept], feats[ept]
    inf = torch.full((p_max, 3), math.inf, device=dev)
    cmin = inf.scatter_reduce(0, seg[:, None].expand(-1, 3), xyz, 'amin')
    cmax = (-inf).scatter_reduce(0, seg[:, None].expand(-1, 3), xyz, 'amax')
    has = torch.isfinite(cmin[:, 0])
    cmin = torch.where(has[:, None], cmin, 0.0)
    cmax = torch.where(has[:, None], cmax, 0.0)
    extent = (cmax - cmin).amax(1)
    inv_shape = float(np.float32(1.0) / np.float32(d))
    cscale = (1.0 / (extent * inv_shape).clamp(min=1e-12) - 0.01).clamp(
        max=float(icfg['scale']))
    cmin_s = cmin * cscale[:, None]
    grid = torch.floor(xyz * cscale[seg][:, None] - cmin_s[seg]).clamp(
        0, d - 1).long()

    cap0, cap1 = caps['inst_voxels']
    key0 = ((seg * d + grid[:, 0]) * d + grid[:, 1]) * d + grid[:, 2]
    uk0, e2v = _capped_unique(key0, cap0)
    c0 = torch.stack([uk0 // d ** 3, uk0 // d ** 2 % d, uk0 // d % d,
                      uk0 % d], 1)
    n0 = len(uk0)
    cnt = torch.zeros(n0 + 1, device=dev).index_add_(
        0, e2v, torch.ones_like(e2v, dtype=torch.float32))[:n0]
    vfeat = torch.zeros((n0 + 1, fe.shape[1]), device=dev).index_add_(
        0, e2v, fe.float())[:n0] / cnt.clamp(min=1)[:, None]
    levels = _grid_levels(c0, d, cap1)
    x = unet(vfeat, levels, P, 'tiny_unet', prec, train=False)
    x = torch.relu(batch_norm(x, P, 'tiny_output_norm', train=False))
    mask_vox = mlp(x, P, 'mask_linear', prec, train=False)
    # an entry whose voxel is past the cap reads the last row (a clamped
    # gather, as every gather of the architecture)
    mask = mask_vox[e2v.clamp(max=n0 - 1)] if n0 == cap0 else mask_vox[e2v]
    vseg = c0[:, 0]
    pooled = torch.zeros((p_max, x.shape[1]), device=dev).index_add_(
        0, vseg, x) / torch.zeros(p_max, device=dev).index_add_(
        0, vseg, torch.ones_like(vseg, dtype=torch.float32)).clamp(
        min=1)[:, None]
    cls = torch.softmax(dense(pooled, P['cls_linear.kernel'],
                              P['cls_linear.bias'], prec), -1)
    iou = dense(pooled, P['iou_score_linear.kernel'],
                P['iou_score_linear.bias'], prec)
    return cls[:n_prop], iou[:n_prop], mask


def _grid_levels(c0: torch.Tensor, d: int, cap1: int) -> list:
    """The tiny U-Net's two levels on the proposal grids: subm neighbours
    within a proposal's d^3 grid, parents on the (d+1)//2 grid (the first
    ``cap1`` in key order; a voxel past them has none)."""
    span = d + 2
    shifted = c0.clone()
    lv0_keys = _lin(shifted, span)
    lv0 = Level(len(c0), c0, _subm_pairs(c0, lv0_keys, span))
    pc = c0.clone()
    pc[:, 1:] = torch.div(c0[:, 1:], 2, rounding_mode='floor')
    pkeys, parent = _capped_unique(_lin(pc, span), cap1)
    xyz = c0[:, 1:]
    lv0.tap = (xyz[:, 0] & 1) * 4 + (xyz[:, 1] & 1) * 2 + (xyz[:, 2] & 1)
    lv0.parent, lv0.n_parent = parent, len(pkeys)
    c1 = torch.stack([pkeys // span ** 3, pkeys // span ** 2 % span - 1,
                      pkeys // span % span - 1, pkeys % span - 1], 1)
    lv1 = Level(len(c1), c1, _subm_pairs(c1, pkeys, span))
    return [lv0, lv1]


def _lin(c: torch.Tensor, span: int) -> torch.Tensor:
    return ((c[:, 0] * span + c[:, 1] + 1) * span + c[:, 2] + 1) * span \
        + c[:, 3] + 1
