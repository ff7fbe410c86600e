"""SoftGroup / SoftGroup++ inference and training in PyTorch (counterpart of
``softgroup_tpu/model/softgroup.py``: ``SoftGroupNet`` setup / ``backbone``
/ ``backbone_voxel_heads`` / ``instance_head`` / ``test_forward`` /
``test_forward_plus`` / ``loss_forward``, ``forward_grouping`` with the
scene pyramid, ``clusters_voxelization``, ``build_keyed_levels``,
``build_pyramid_from_voxels``, the losses).

Shapes are static capacities with validity masks, as in the reference, so
the outputs of ``test_forward`` carry the same keys and layouts: proposals
are a CSR of (entry_pt, entry_seg, entry_valid) truncated at the same
capacities.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.gather_kernel import gather_rows, row_gather
from ..ops.geometry import LevelGeom, Pyramid, row_ordered
from ..ops.grouping import ball_cluster, cell_cluster_csr
from ..ops.masks import mask_iou_on_cluster, mask_iou_on_pred, mask_label
from ..ops.rulebook import build_downsample_linear, build_subm_rules_linear
from ..ops.segment import (segment_max, segment_mean, segment_mean_fused,
                           segment_min)
from ..ops.voxelize import (compact_ascending, devoxelize, voxel_features,
                            voxelize_linear)
from ..util.config import getattr_or
from ..util.trace import traced
from .blocks import MLP, Dense, MaskedBatchNorm, SubMConv, UBlock

INT_MAX = 2 ** 31 - 1


@dataclass
class SceneBatch:
    """Static-shape batch of tensors (built by data/padding.py)."""
    pyramid: Pyramid
    feats: torch.Tensor              # (P, C_in) colors
    coords_float: torch.Tensor       # (P, 3) metric coords
    batch_idxs: torch.Tensor         # (P,) int32
    semantic_labels: torch.Tensor    # (P,) int32, ignore_label padded
    instance_labels: torch.Tensor    # (P,) int32, ignore_label padded
    pt_offset_labels: torch.Tensor   # (P, 3)
    instance_pointnum: torch.Tensor  # (I,) int32
    instance_cls: torch.Tensor       # (I,) int32
    instance_valid: torch.Tensor     # (I,) bool
    # (V0, C_in) host-built voxel-mean network input; None: averaged on
    # the device from feats (and coords_float, per with_coords)
    vox_in: torch.Tensor | None = None
    point_perm: torch.Tensor | None = None   # (P,) original index of a row

    def apply(self, fn) -> 'SceneBatch':
        """A copy with ``fn`` applied to each of its tensors."""
        return SceneBatch(**{
            k: (v.apply(fn) if isinstance(v, Pyramid)
                else None if v is None else fn(v))
            for k, v in vars(self).items()})

    def to(self, device, non_blocking: bool = False) -> 'SceneBatch':
        return self.apply(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> 'SceneBatch':
        """The batch in page-locked host memory (what
        ``torch.utils.data.DataLoader(pin_memory=True)`` calls), so that
        ``to(device, non_blocking=True)`` copies it asynchronously."""
        return self.apply(torch.Tensor.pin_memory)


class Capacities(NamedTuple):
    """Static paddings: every dynamic size becomes a capacity + mask."""
    points: int
    voxels: tuple
    grouping_points: int
    proposals: int
    proposal_entries: int
    instances: int
    inst_voxels: tuple
    grouping_cells: int = 65536


class Proposals(NamedTuple):
    """Static-capacity CSR proposal layout."""
    entry_pt: torch.Tensor      # (S,) int32 point index per entry
    entry_seg: torch.Tensor     # (S,) int32 proposal id (cap = invalid)
    entry_valid: torch.Tensor   # (S,) bool
    n_proposals: torch.Tensor   # () int32
    prop_valid: torch.Tensor    # (Pmax,) bool


class SoftGroupNet(nn.Module):
    """Backbone U-Net + point heads + the refinement heads.

    ``bf16``: backbone and refinement convs compute in bf16 with f32 sums
    (the reference's policy); heads return f32.  ``generator`` seeds the
    init (the reference's initializers; parameters are created on the CPU,
    move the module with ``.to(device)``).  Each ``MaskedBatchNorm`` follows
    its module's train/eval mode (``train.make_train_step`` keeps frozen
    modules in eval mode, as the reference's ``_t`` does)."""

    def __init__(self, channels: int = 32, num_blocks: int = 7,
                 semantic_classes: int = 20, instance_classes: int = 18,
                 semantic_only: bool = False, bf16: bool = True,
                 in_channels: int = 6,
                 generator: torch.Generator | None = None):
        super().__init__()
        ch = channels
        g = generator
        self.semantic_only = semantic_only
        self.bf16 = bf16
        self.input_conv = SubMConv(in_channels, ch, g)
        self.unet = UBlock([ch * (i + 1) for i in range(num_blocks)],
                           block_reps=2, generator=g)
        self.output_norm = MaskedBatchNorm(ch)
        self.semantic_linear = MLP(ch, semantic_classes, norm=True,
                                   num_layers=2, generator=g)
        self.offset_linear = MLP(ch, 3, norm=True, num_layers=2, generator=g)
        if not semantic_only:
            self.tiny_unet = UBlock([ch, 2 * ch], block_reps=2, generator=g)
            self.tiny_output_norm = MaskedBatchNorm(ch)
            self.cls_linear = Dense(ch, instance_classes + 1, g)
            self.mask_linear = MLP(ch, instance_classes + 1, norm=False,
                                   num_layers=2, generator=g)
            self.iou_score_linear = Dense(ch, instance_classes + 1, g)

    def _voxel_feats(self, x: torch.Tensor, pyramid: Pyramid):
        """input_conv -> UBlock -> BN/ReLU on the level-0 voxels, every
        submanifold conv on its level's row order (built here, once a
        level)."""
        levels = row_ordered(pyramid.levels)
        x = x.to(torch.bfloat16 if self.bf16 else torch.float32)
        x = self.input_conv(x, levels[0])
        x = self.unet(x, levels)
        return self.output_norm(x, levels[0].vox_valid, relu=True)

    @traced('model.backbone')
    def backbone(self, x: torch.Tensor, pyramid: Pyramid):
        """input_conv -> UBlock -> BN/ReLU -> devoxelize -> point heads.
        ``x`` is the voxel-level input (V0, C_in)."""
        output_feats = devoxelize(self._voxel_feats(x, pyramid), pyramid.p2v)
        pmask = pyramid.point_valid
        semantic_scores = self.semantic_linear(output_feats, pmask).float()
        pt_offsets = self.offset_linear(output_feats, pmask).float()
        return semantic_scores, pt_offsets, output_feats

    @traced('model.backbone')
    def backbone_voxel_heads(self, x: torch.Tensor, pyramid: Pyramid):
        """SoftGroup++ lvl_fusion: the point heads on the level-0 voxels
        (no devoxelize)."""
        x = self._voxel_feats(x, pyramid)
        vmask = pyramid.levels[0].vox_valid
        semantic_scores = self.semantic_linear(x, vmask).float()
        pt_offsets = self.offset_linear(x, vmask).float()
        return semantic_scores, pt_offsets, x

    def _input_voxels(self, batch: SceneBatch, cfg) -> torch.Tensor:
        """The voxel-level network input: the host-built ``vox_in``, else
        the mean of the point features per level-0 voxel."""
        if batch.vox_in is not None:
            return batch.vox_in
        feats = batch.feats
        if cfg.with_coords:
            feats = torch.cat([feats, batch.coords_float], dim=1)
        v0 = batch.pyramid.levels[0].vox_valid.shape[0]
        return voxel_features(feats, batch.pyramid.p2v, v0)

    @traced('model.refine')
    def instance_head(self, inst_vox_feats, inst_levels, entry_p2v,
                      n_proposal_cap: int):
        """tiny U-Net (rulebook levels on their row orders, built here)
        + cls / mask / iou heads."""
        lv0 = inst_levels[0]
        x = inst_vox_feats.to(torch.bfloat16 if self.bf16
                              else torch.float32)
        x = self.tiny_unet(x, row_ordered(inst_levels))
        x = self.tiny_output_norm(x, lv0.vox_valid, relu=True)
        mask_scores_vox = self.mask_linear(x, lv0.vox_valid)
        mask_scores = gather_rows(mask_scores_vox, entry_p2v)
        # proposal-level pooled features; a voxel's proposal id is its
        # batch coordinate
        vox_seg = torch.where(lv0.vox_valid, lv0.vox_coords[:, 0],
                              n_proposal_cap)
        pooled = segment_mean(x, vox_seg, n_proposal_cap)
        cls_scores = self.cls_linear(pooled).float()
        iou_scores = self.iou_score_linear(pooled).float()
        return cls_scores, iou_scores, mask_scores.float()

    @torch.no_grad()
    def test_forward(self, batch: SceneBatch, cfg, caps: Capacities) -> dict:
        """Device part of inference; host instance extraction lives in
        evaluation/postprocess.py."""
        sem, off, outf = self.backbone(self._input_voxels(batch, cfg),
                                       batch.pyramid)
        out = dict(semantic_scores=sem, pt_offsets=off,
                   semantic_preds=torch.argmax(sem, dim=1))
        if not self.semantic_only:
            out.update(self._group_and_refine(
                sem, off, outf, batch.batch_idxs, batch.coords_float,
                batch.pyramid.point_valid, cfg, caps))
        return out

    @torch.no_grad()
    def test_forward_plus(self, batch: SceneBatch, cfg,
                          caps: Capacities) -> dict:
        """SoftGroup++ lvl_fusion inference: grouping and refinement run on
        the level-0 voxels (``entry_pt`` indexes voxels; the host maps
        masks back to points through p2v).  The point-level semantics and
        offsets are the voxel heads gathered through p2v, one K2 gather of
        both heads (pad points read the last voxel, as the reference's
        clipped gather)."""
        lv0 = batch.pyramid.levels[0]
        v0 = lv0.vox_valid.shape[0]
        sem_v, off_v, outf_v = self.backbone_voxel_heads(
            self._input_voxels(batch, cfg), batch.pyramid)
        p2v = batch.pyramid.p2v
        n_sem = sem_v.shape[1]
        heads = devoxelize(torch.cat([sem_v, off_v], dim=1), p2v)
        sem_pt = heads[:, :n_sem]
        out = dict(semantic_scores=sem_pt, pt_offsets=heads[:, n_sem:],
                   semantic_preds=torch.argmax(sem_pt, dim=1))
        if not self.semantic_only:
            vox_cf = voxel_features(batch.coords_float, p2v, v0)
            vox_batch = torch.where(lv0.vox_valid, lv0.vox_coords[:, 0], 0)
            out.update(self._group_and_refine(
                sem_v, off_v, outf_v, vox_batch, vox_cf, lv0.vox_valid, cfg,
                caps))
        return out

    def _group_and_refine(self, sem, off, feats, batch_idxs, coords,
                          valid, cfg, caps: Capacities) -> dict:
        """Soft grouping of the rows (points, or voxels under lvl_fusion),
        their re-voxelization and the refinement heads."""
        props = forward_grouping(sem, off, batch_idxs, coords, valid, cfg,
                                 caps)
        vox_feats, levels, entry_p2v = clusters_voxelization(
            props, feats, coords, float(cfg.instance_voxel_cfg.scale),
            int(cfg.instance_voxel_cfg.spatial_shape), caps)
        cls_scores, iou_scores, mask_scores = self.instance_head(
            vox_feats, levels, entry_p2v, caps.proposals)
        return dict(
            cls_scores=torch.softmax(cls_scores, dim=-1),
            iou_scores=iou_scores, mask_scores=mask_scores,
            entry_pt=props.entry_pt, entry_seg=props.entry_seg,
            entry_valid=props.entry_valid, n_proposals=props.n_proposals)

    def loss_forward(self, batch: SceneBatch, cfg, caps: Capacities,
                     generator: torch.Generator | None = None,
                     rand: torch.Tensor | None = None):
        """Training forward -> (total loss, log_vars).  ``rand``: the (2, 3)
        uniform numbers of the proposal grids' random quantization (r1, r2;
        drawn from ``generator`` when not given).  Grouping runs on detached
        scores and offsets."""
        sem, off, outf = self.backbone(self._input_voxels(batch, cfg),
                                       batch.pyramid)
        losses = point_wise_loss(sem, off, batch.semantic_labels,
                                 batch.instance_labels,
                                 batch.pt_offset_labels,
                                 batch.pyramid.point_valid, cfg)
        if not self.semantic_only:
            if rand is None:
                rand = torch.rand((2, 3), generator=generator)
            props = forward_grouping(sem.detach(), off.detach(),
                                     batch.batch_idxs, batch.coords_float,
                                     batch.pyramid.point_valid, cfg, caps)
            vox_feats, levels, entry_p2v = clusters_voxelization(
                props, outf, batch.coords_float,
                float(cfg.instance_voxel_cfg.scale),
                int(cfg.instance_voxel_cfg.spatial_shape), caps,
                rand=rand.to(device=sem.device, dtype=torch.float32))
            cls_scores, iou_scores, mask_scores = self.instance_head(
                vox_feats, levels, entry_p2v, caps.proposals)
            losses.update(instance_loss(
                cls_scores, mask_scores, iou_scores, props,
                batch.instance_labels, batch.instance_pointnum,
                batch.instance_cls, batch.instance_valid, cfg))
        return parse_losses(losses)


# ---------------------------------------------------------------------------
# Grouping (no parameters)
# ---------------------------------------------------------------------------

def _ignored(gcfg, n_cls: int, dev) -> torch.Tensor:
    ignore = torch.zeros((n_cls,), dtype=torch.bool, device=dev)
    ignore[list(gcfg.ignore_classes)] = True
    return ignore


def _active(scores: torch.Tensor, point_valid: torch.Tensor, gcfg,
            ignore: torch.Tensor) -> torch.Tensor:
    """(C, P): the valid rows whose softmax score of a non-ignored class
    clears score_thr."""
    return ((scores.T > float(gcfg.score_thr)) & point_valid[None, :]
            & ~ignore[:, None])


def class_active_counts(semantic_scores: torch.Tensor,
                        point_valid: torch.Tensor, gcfg) -> torch.Tensor:
    """(C,) active rows a class: what grouping gates classes and pyramid
    levels on."""
    scores = torch.softmax(semantic_scores.float(), dim=-1)
    ignore = _ignored(gcfg, scores.shape[1], scores.device)
    return _active(scores, point_valid, gcfg, ignore).sum(dim=1)


def pyramid_levels(counts: torch.Tensor, gcfg) -> torch.Tensor:
    """SoftGroup++ scene pyramid: each class's level (1, 2 or 3, f32) from
    its active count, above the first / second of
    ``pyramid_thresholds``."""
    lo, hi = getattr_or(gcfg, 'pyramid_thresholds', (100000, 1000000))
    return torch.where(counts > hi, 3.0, torch.where(counts > lo, 2.0, 1.0))


@traced('model.grouping')
def forward_grouping(semantic_scores: torch.Tensor, pt_offsets: torch.Tensor,
                     batch_idxs: torch.Tensor, coords_float: torch.Tensor,
                     point_valid: torch.Tensor, cfg: Any,
                     caps: Any) -> Proposals:
    """Class-wise soft grouping.  A point joins every non-ignored class
    whose softmax score clears score_thr; classes with fewer than min_npoint
    active points yield nothing; all classes cluster in one call (the group
    key separates them) and components below the class-size threshold are
    dropped.  Clustering contracts grid cells (``cell_cluster_csr``), or,
    with ``exact_ball_query``, links entries within the radius
    (``ball_cluster``).

    ``with_pyramid`` (SoftGroup++): a class's entry coordinates are divided
    by its pyramid level, which equals scaling its cell size and radius by
    the level (the group key keeps classes apart).  A true f32 division,
    as the reference's: a product with 1/3 rounds otherwise."""
    gcfg = cfg.grouping_cfg
    dev = semantic_scores.device
    p, n_cls = semantic_scores.shape
    n_tot = caps.grouping_points
    scores = torch.softmax(semantic_scores.float(), dim=-1)

    ignore = _ignored(gcfg, n_cls, dev)
    numpoint_mean = torch.tensor(gcfg.class_numpoint_mean,
                                 dtype=torch.float32, device=dev)
    radius = float(gcfg.radius)
    score_thr = float(gcfg.score_thr)
    npoint_thr = float(gcfg.npoint_thr)
    min_npoint = int(cfg.test_cfg.min_npoint)

    active = _active(scores, point_valid, gcfg, ignore)           # (C, P)
    counts = active.sum(dim=1)
    active &= (counts >= min_npoint)[:, None]

    # at most floor(1/score_thr) classes can clear score_thr per point (+1
    # for softmax rounding), so a per-point top-k covers every entry
    k_cand = min(n_cls, int(np.floor(1.0 / max(score_thr, 1e-6))) + 1)
    shifted_pts = coords_float + pt_offsets.float()
    wide_src = torch.cat([shifted_pts, batch_idxs.float()[:, None]], dim=1)
    if k_cand < n_cls:
        # stable descending sort = the reference's top_k (ties keep the
        # lower class first)
        top_s, top_c = torch.sort(scores, dim=1, descending=True,
                                  stable=True)
        top_s, top_c = top_s[:, :k_cand], top_c[:, :k_cand].to(torch.int32)
        class_ok = (counts >= min_npoint) & ~ignore
        cand = (top_s > score_thr) & point_valid[:, None] \
            & class_ok[top_c.long()]
        idx = compact_ascending(cand.reshape(-1), n_tot, p * k_cand)
        valid_e = idx < p * k_cand
        pt_e = torch.where(valid_e, idx // k_cand, p - 1)
        wide = row_gather(wide_src, pt_e)
        cls_e = torch.where(valid_e, row_gather(top_c.reshape(-1), idx), 0)
    else:
        idx = compact_ascending(active.reshape(-1), n_tot, n_cls * p)
        valid_e = idx < n_cls * p
        cls_e = torch.where(valid_e, idx // p, 0)
        pt_e = torch.where(valid_e, idx % p, 0)
        wide = row_gather(wide_src, pt_e)
    shifted = wide[:, :3].contiguous()
    if getattr_or(gcfg, 'with_pyramid', False):
        shifted = shifted / pyramid_levels(counts, gcfg)[cls_e.long()][:, None]
    group = wide[:, 3].to(torch.int32) * n_cls + cls_e

    thr_cls = torch.where(numpoint_mean == -1.0,
                          torch.full_like(numpoint_mean, npoint_thr),
                          npoint_thr * numpoint_mean)
    if getattr_or(gcfg, 'exact_ball_query', False):
        # point-level radius-graph components, labelled by their minimum
        # entry index; the class-size threshold in that label space
        labels = ball_cluster(shifted, group, valid_e, radius)
        sizes = torch.zeros((n_tot + 1,), dtype=torch.float32,
                            device=dev).index_add_(
            0, torch.where(labels >= 0, labels, n_tot).long(),
            torch.ones((n_tot,), dtype=torch.float32, device=dev))
        size_of = sizes[labels.long().clamp(0, n_tot - 1)]
        keep = valid_e & (labels >= 0) & (size_of >= thr_cls[cls_e.long()])
        key = torch.where(keep, labels, INT_MAX)
        pt_sorted = pt_e
    else:
        ent_label, pt_sorted = cell_cluster_csr(
            shifted, group, valid_e, pt_e, thr_cls, radius,
            cell_scale=float(getattr_or(gcfg, 'cell_scale', 1.0)),
            m_cap=caps.grouping_cells,
            pair_keys=bool(getattr_or(gcfg, 'pair_keys', True)))
        key = torch.where(ent_label >= 0, ent_label, INT_MAX)

    # global static CSR
    s_cap, p_max = caps.proposal_entries, caps.proposals
    key_s, order = torch.sort(key, stable=True)
    pt_s = pt_sorted[order]
    valid_s = key_s != INT_MAX
    prev = torch.cat([key_s.new_full((1,), -1), key_s[:-1]])
    firsts = valid_s & (key_s != prev)
    pid = torch.cumsum(firsts.to(torch.int32), 0, dtype=torch.int32) - 1
    n_proposals = (pid[-1] + 1).clamp(min=0, max=p_max)

    entry_pt = pt_s[:s_cap]
    pid = pid[:s_cap]
    entry_valid = valid_s[:s_cap] & (pid < p_max) & (pid >= 0)
    entry_seg = torch.where(entry_valid, pid, p_max).to(torch.int32)
    prop_valid = torch.arange(p_max, device=dev) < n_proposals
    return Proposals(entry_pt.to(torch.int32), entry_seg, entry_valid,
                     n_proposals.to(torch.int32), prop_valid)


# ---------------------------------------------------------------------------
# Cluster re-voxelization (no parameters)
# ---------------------------------------------------------------------------

@traced('model.voxelize')
def clusters_voxelization(props: Proposals, feats: torch.Tensor,
                          coords_float: torch.Tensor, scale: float,
                          spatial_shape: int, caps: Any,
                          rand: torch.Tensor | None = None):
    """Scale each proposal into a spatial_shape^3 grid and voxelize, with
    the proposal id as the batch coordinate.  Returns (vox_feats, levels,
    entry_p2v).

    Inference (``rand`` None) at an even ``spatial_shape``: keyed levels
    for K4.  Training, and inference at an odd shape (as the reference):
    levels with explicit rulebooks (K7) for K1; in training ``rand`` is
    (r1, r2), the (2, 3) uniform numbers of the random quantization, one
    3-vector shared by all clusters, and the conv backwards reuse the
    rulebooks."""
    p_max = props.prop_valid.shape[0]
    comb = gather_rows(torch.cat([coords_float, feats.float()], dim=1),
                       props.entry_pt)
    # every path from the coordinates to the loss ends in a floor, so their
    # gradient is exactly zero: detach them
    coords, fe = comb[:, :3].detach(), comb[:, 3:]
    seg = torch.where(props.entry_valid, props.entry_seg, p_max)

    cmin = segment_min(coords, seg, p_max)
    cmax = segment_max(coords, seg, p_max)
    extent = (cmax - cmin).amax(dim=1)
    # extent / spatial_shape as a product with the f32 reciprocal, as XLA
    # and PyTorch's CUDA division by a number compute it (the CPU's true
    # quotient is an ulp off for ~20% of extents, enough to floor a point
    # on a cell's edge into the next voxel on one device only)
    inv_shape = float(np.float32(1.0) / np.float32(spatial_shape))
    clusters_scale = 1.0 / (extent * inv_shape).clamp(min=1e-12) - 0.01
    clusters_scale = clusters_scale.clamp(max=scale)

    cmin_s = cmin * clusters_scale[:, None]
    if rand is not None:
        rng_range = cmax * clusters_scale[:, None] - cmin_s
        cmin_s = cmin_s - (spatial_shape - rng_range - 0.001).clamp(
            min=0) * rand[0]
        cmin_s = cmin_s - (spatial_shape - rng_range + 0.001).clamp(
            max=0) * rand[1]
    par = torch.cat([clusters_scale[:, None], cmin_s], dim=1)
    pe = par[seg.long().clamp(0, p_max - 1)]
    grid = coords * pe[:, :1] - pe[:, 1:]
    grid = torch.floor(grid).clamp(0, spatial_shape - 1).to(torch.int32)
    c4 = torch.cat([seg[:, None].to(torch.int32), grid], dim=1)

    dims = (spatial_shape,) * 3
    vx, ckey = voxelize_linear(c4, props.entry_valid, dims,
                               caps.inst_voxels[0])
    vox_feats = segment_mean_fused(fe, vx.p2v, caps.inst_voxels[0])
    if rand is None and spatial_shape % 2 == 0:
        levels = build_keyed_levels(vx, ckey, spatial_shape,
                                    caps.inst_voxels)
    else:
        levels = build_pyramid_from_voxels(vx, ckey, dims, caps.inst_voxels)
    return vox_feats, levels, vx.p2v


def build_keyed_levels(vx, ckey, spatial_shape: int,
                       capacities: Sequence[int]):
    """Two-level keyed geometry for the tiny U-Net: sorted key tables plus
    the parent/tap maps of the inverse conv; the keyed conv kernel (K4)
    resolves neighbours itself."""
    d, dc = spatial_shape, (spatial_shape + 1) // 2
    xyz = vx.vox_coords[:, 1:]
    child_tap = ((xyz[:, 0] & 1) * 4 + (xyz[:, 1] & 1) * 2
                 + (xyz[:, 2] & 1)).to(torch.int32)
    parent_coords = torch.cat([vx.vox_coords[:, :1], xyz // 2], dim=1)
    vx2, ckey2 = voxelize_linear(parent_coords, vx.vox_valid, (dc,) * 3,
                                 capacities[1])
    dev = ckey.device
    lv0 = LevelGeom(vx.vox_coords, vx.vox_valid, None, None, vx2.p2v,
                    child_tap, torch.tensor([d] * 3, device=dev), ckey=ckey,
                    spatial_d=d)
    lv1 = LevelGeom(vx2.vox_coords, vx2.vox_valid, None, None, None, None,
                    torch.tensor([dc] * 3, device=dev), ckey=ckey2,
                    spatial_d=dc)
    return (lv0, lv1)


def build_pyramid_from_voxels(vx, ckey, dims, capacities: Sequence[int]):
    """Tiny-U-Net rulebook levels of the training step from a device
    voxelization: per level the (27, V) subm rulebook (K7) and, but for the
    last, the down rulebook and parent/tap maps to the next level."""
    levels = []
    coords, valid, key, dims = vx.vox_coords, vx.vox_valid, ckey, tuple(dims)
    for lvl in range(len(capacities)):
        dims_t = torch.tensor(dims, dtype=torch.int32, device=ckey.device)
        subm = build_subm_rules_linear(key, coords, valid, dims_t)
        if lvl + 1 == len(capacities):
            levels.append(LevelGeom(coords, valid, subm, None, None, None,
                                    dims_t))
            break
        (nxt_coords, nxt_valid, _, down, parent, tap, nxt_key,
         nxt_dims) = build_downsample_linear(coords, valid, dims,
                                             capacities[lvl + 1])
        levels.append(LevelGeom(coords, valid, subm, down, parent, tap,
                                dims_t))
        coords, valid, key, dims = nxt_coords, nxt_valid, nxt_key, nxt_dims
    return tuple(levels)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def point_wise_loss(semantic_scores, pt_offsets, semantic_labels,
                    instance_labels, pt_offset_labels, point_valid, cfg):
    """Semantic CE (+ class weights) with ignore_label, masked offset L1."""
    ignore = cfg.ignore_label
    n_cls = semantic_scores.shape[1]
    sem_valid = point_valid & (semantic_labels != ignore)
    tgt = semantic_labels.long().clamp(0, n_cls - 1)
    logp = torch.log_softmax(semantic_scores.float(), dim=-1)
    ce = -logp.gather(1, tgt[:, None])[:, 0]
    weight = getattr_or(cfg, 'semantic_weight', None)
    if weight is not None:
        w = torch.tensor(weight, dtype=torch.float32, device=ce.device)[tgt]
    else:
        w = torch.ones_like(ce)
    w = w * sem_valid.float()
    semantic_loss = (ce * w).sum() / w.sum().clamp(min=1e-12)

    pos = point_valid & (instance_labels != ignore)
    d = pt_offsets.float() - pt_offset_labels.float()
    # |d| with the reference's derivative at 0 (+1, jnp.abs's; torch.abs
    # gives 0 there, and a zero offset head sits exactly on it)
    diff = torch.where(d >= 0, d, -d)
    npos = pos.sum()
    offset_loss = torch.where(
        npos > 0, (diff * pos[:, None]).sum() / npos.clamp(min=1).float(),
        0.0)
    return dict(semantic_loss=semantic_loss, offset_loss=offset_loss)


def _take(scores, labels):
    return torch.gather(scores.float(), 1, labels.long()[:, None])[:, 0]


def instance_loss(cls_scores, mask_scores, iou_scores, props: Proposals,
                  instance_labels, instance_pointnum, instance_cls,
                  instance_valid, cfg):
    """Refinement losses: proposal-gt assignment by IoU (with the optional
    ``match_low_quality`` claims), CE cls loss, masked BCE mask loss, MSE
    IoU-score loss; every reduction masked, so an empty batch gives zeros."""
    k = cfg.instance_classes
    p_max = props.prop_valid.shape[0]
    n_inst = instance_pointnum.shape[0]
    dev = cls_scores.device
    pos_iou_thr = float(cfg.train_cfg.pos_iou_thr)
    prop_valid = props.prop_valid

    ious = mask_iou_on_cluster(props.entry_pt, props.entry_seg,
                               props.entry_valid, instance_labels,
                               instance_pointnum, p_max)   # (Pmax, I)
    fg = instance_valid & (instance_cls != cfg.ignore_label)
    neg = torch.full_like(ious, -1.0)
    fg_ious = torch.where(fg[None, :], ious, neg)
    max_iou, argmax_iou = fg_ious.max(dim=1).values, fg_ious.argmax(dim=1)
    assigned = (max_iou >= pos_iou_thr) & prop_valid

    if getattr_or(cfg.train_cfg, 'match_low_quality', False):
        # each fg gt claims its best proposal; later gts win ties
        min_pos_thr = float(getattr_or(cfg.train_cfg, 'min_pos_thr', 0.0))
        col_ious = torch.where(prop_valid[:, None], ious, neg)
        gt_max, gt_argmax = col_ious.max(dim=0).values, col_ious.argmax(0)
        claim_ok = fg & (gt_max >= min_pos_thr)
        gts = torch.arange(n_inst, dtype=torch.int32, device=dev)
        claimer = torch.full((p_max + 1,), -1, dtype=torch.int32,
                             device=dev).scatter_reduce(
            0, torch.where(claim_ok, gt_argmax, p_max),
            torch.where(claim_ok, gts, -1), reduce='amax')[:p_max]
        assigned = assigned | (claimer >= 0)
        argmax_iou = torch.where(claimer >= 0, claimer.clamp(min=0).long(),
                                 argmax_iou)

    gt_cls = instance_cls[argmax_iou.clamp(0, n_inst - 1)]
    labels = torch.where(assigned, gt_cls.clamp(0, k - 1), k)

    logp = torch.log_softmax(cls_scores.float(), dim=-1)
    ce = -_take(logp, labels)
    pv = prop_valid.float()
    have = fg.any() & (props.n_proposals > 0)
    cls_loss = torch.where(have, (ce * pv).sum() / pv.sum().clamp(min=1.0),
                           0.0)

    seg = props.entry_seg.long().clamp(0, p_max - 1)
    ms_sig = torch.sigmoid(_take(mask_scores, labels[seg]))
    mlabel = mask_label(props.entry_pt, props.entry_seg, props.entry_valid,
                        instance_labels, instance_cls, ious, pos_iou_thr,
                        cfg.ignore_label)
    mw = ((mlabel != -1.0) & props.entry_valid).float()
    tgt = mlabel.clamp(0.0, 1.0)
    eps = 1e-12
    bce = -(tgt * torch.log(ms_sig.clamp(min=eps))
            + (1 - tgt) * torch.log((1 - ms_sig).clamp(min=eps)))
    mask_loss = torch.where(have, (bce * mw).sum() / (mw.sum() + 1.0), 0.0)

    ious_pred = mask_iou_on_pred(props.entry_pt, props.entry_seg,
                                 props.entry_valid, instance_labels,
                                 instance_pointnum, ms_sig.detach(), p_max)
    fg_pred = torch.where(fg[None, :], ious_pred, torch.full_like(ious_pred,
                                                                   -1.0))
    gt_ious = fg_pred.max(dim=1).values.clamp(min=0.0)
    iw = ((labels < k) & prop_valid).float()
    iou_score_loss = torch.where(
        have, ((_take(iou_scores, labels) - gt_ious).square() * iw).sum()
        / (iw.sum() + 1.0), 0.0)

    num_pos = ((labels < k) & prop_valid).sum().float()
    num_neg = ((labels >= k) & prop_valid).sum().float()
    return dict(cls_loss=cls_loss, mask_loss=mask_loss,
                iou_score_loss=iou_score_loss, num_pos=num_pos,
                num_neg=num_neg)


def parse_losses(losses: dict):
    """Total = the sum of the entries whose key contains 'loss'; log_vars
    adds it under 'loss'."""
    total = sum(v for key, v in losses.items() if 'loss' in key)
    log_vars = dict(losses)
    log_vars['loss'] = total
    return total, log_vars
