"""Inference runner and evaluation loop (counterpart of
``softgroup_tpu/tools_impl/test_runner.py``: ``bucketed_caps``,
``InferenceRunner``, ``run_eval`` and ``summarize``).

A request is ``run_scene(data)`` on one collated scan: the host batch at
per-scene bucketed capacities (``build_batch``, native host geometry), the
device forward (``test_forward``, or ``test_forward_plus`` when
``test_cfg.lvl_fusion`` is set), then the host postprocess in the scan's
original point order: the instances and, for a ``'panoptic'`` task, their
panoptic fusion over the semantic predictions.  ``run_split`` runs every
scan of a config's test split through it, ``summarize`` scores them
(instance AP, mIoU, accuracy, offset MAE, PQ) and ``run_eval`` does both.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from ..data.loader import build_dataloader, build_dataset
from ..data.padding import build_scene_batch, round_capacity
from ..evaluation.instance_eval import ScanNetEval
from ..evaluation.panoptic_eval import PanopticEval
from ..evaluation.point_wise_eval import (evaluate_offset_mae,
                                          evaluate_semantic_acc,
                                          evaluate_semantic_miou)
from ..evaluation.postprocess import (get_gt_instances, get_instances,
                                      panoptic_fusion, to_numpy)
from ..model.softgroup import Capacities
from ..ops.geometry import host_geometry
from ..util import trace
from ..util.config import getattr_or


def bucketed_caps(n_points: int, voxel_counts, base: Capacities,
                  lvl_fusion: bool = False) -> Capacities:
    """Per-scene capacities rounded to sqrt(2) buckets, so scenes of
    similar size share one set of shapes.

    lvl_fusion: grouping and refinement run on the level-0 voxels
    (``test_forward_plus``), so the entry caps follow the voxel count."""
    rows = voxel_counts[0] if lvl_fusion else n_points
    return Capacities(
        points=round_capacity(n_points),
        voxels=tuple(round_capacity(v, minimum=256) for v in voxel_counts),
        grouping_points=round_capacity(2 * rows, minimum=8192),
        proposals=base.proposals,
        proposal_entries=min(round_capacity(6 * rows, minimum=8192),
                             base.proposal_entries),
        instances=base.instances,
        inst_voxels=base.inst_voxels,
    )


class InferenceRunner:
    """Runs collated scans through ``net`` on ``device`` (the net must be
    there already)."""

    def __init__(self, net, model_cfg, base_caps: Capacities,
                 num_levels: int, device='cuda'):
        self.net = net
        self.cfg = model_cfg
        self.base_caps = base_caps
        self.num_levels = num_levels
        self.device = torch.device(device)
        self.lvl_fusion = bool(self.cfg.test_cfg.get('lvl_fusion', False))

    @trace.traced('runner.forward')
    def forward(self, batch, caps: Capacities) -> dict:
        """The device outputs (tensors) of one batch."""
        method = (self.net.test_forward_plus if self.lvl_fusion
                  else self.net.test_forward)
        return method(batch, self.cfg, caps)

    def build_batch(self, data: dict, native: bool = True):
        """Host: the pyramid of one collated scan, built once at its own
        sizes, then padded to the capacities bucketed on its level counts;
        ``native=False`` builds with numpy (the same arrays)."""
        coords = data['coords']
        geom = host_geometry(coords, data['spatial_shape'], self.num_levels,
                             native)
        caps = bucketed_caps(len(coords), geom.counts, self.base_caps,
                             lvl_fusion=self.lvl_fusion)
        batch = build_scene_batch(
            data['coords'], data['coords_float'], data['feats'],
            data['semantic_labels'], data['instance_labels'],
            data['pt_offset_labels'], data['instance_pointnum'],
            data['instance_cls'], data['spatial_shape'], caps,
            self.num_levels, self.cfg.ignore_label,
            batch_idxs=data.get('grouping_batch_idxs'),
            with_coords=self.cfg.get('with_coords', True),
            device=self.device, geometry=geom)
        return batch, caps

    def run_scene(self, data: dict, stats: dict | None = None) -> dict:
        """One scan's results, per point in the scan's original order.

        ``stats``, when given, receives the capacities (``caps``), the
        points and level-0 voxels (``n_points``, ``n_voxels``), the
        proposal and instance counts, the instances pasted by the panoptic
        fusion (``n_pasted``, a ``'panoptic'`` task) and the host clock of
        each stage in ms (``host_batch_ms``, ``forward_ms`` with the device
        synchronised, ``postprocess_ms``: the copy to the host, the
        instances and their fusion), read from the stages' spans (the scan
        opens a trace session for them where none is open)."""
        own = stats is not None and not trace.active()
        with trace.session() if own else nullcontext():
            return self._run_scene(data, stats)

    def _run_scene(self, data: dict, stats: dict | None) -> dict:
        tasks = self.cfg.test_cfg.eval_tasks
        scan_id = data['scan_ids'][0]
        n = len(data['coords'])
        with trace.span('runner.host_batch') as host:
            batch, caps = self.build_batch(data)
        out = self.forward(batch, caps)
        if stats is not None and self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        with trace.span('runner.postprocess') as post:
            out = to_numpy(out)

            # the batch is in voxel-sorted point order (data/padding.py);
            # every per-point output goes back to the scan's order here
            perm = (batch.point_perm[:n].cpu().numpy()
                    if batch.point_perm is not None else None)

            def unperm(a):
                if perm is None:
                    return a
                o = np.empty_like(a)
                o[perm] = a
                return o

            sem_preds = unperm(out['semantic_preds'][:n])
            if perm is not None:
                # get_instances reads point-level fields straight from
                # `out`
                out['semantic_preds'] = np.concatenate(
                    [sem_preds, out['semantic_preds'][n:]])
                if 'entry_pt' in out and not self.lvl_fusion:
                    # proposal entries index points in sorted order (under
                    # lvl_fusion they index voxels and stay as they are)
                    ev = out['entry_valid']
                    pts = perm[np.clip(out['entry_pt'], 0, n - 1)]
                    out['entry_pt'] = np.where(ev, pts, out['entry_pt'])

            ret = dict(scan_id=scan_id)
            if 'semantic' in tasks or 'panoptic' in tasks:
                ret.update(semantic_labels=data['semantic_labels'],
                           instance_labels=data['instance_labels'])
            if 'semantic' in tasks:
                ret.update(
                    coords_float=data['coords_float'],
                    color_feats=data['feats'],
                    semantic_preds=sem_preds,
                    offset_preds=unperm(out['pt_offsets'][:n]),
                    offset_labels=data['pt_offset_labels'])
            pred_instances = ()
            if not self.net.semantic_only and (
                    'instance' in tasks or 'panoptic' in tasks):
                if self.lvl_fusion:
                    # masks live on voxels: expand through the un-permuted
                    # p2v
                    p2v = unperm(batch.pyramid.p2v[:n].cpu().numpy())
                    n_vox = int(batch.pyramid.levels[0].vox_valid.sum())
                    pred_instances = get_instances(scan_id, out, n_vox,
                                                   self.cfg, v2p_map=p2v)
                else:
                    pred_instances = get_instances(scan_id, out, n, self.cfg)
                if 'instance' in tasks:
                    ret['pred_instances'] = pred_instances
                    ret['gt_instances'] = get_gt_instances(
                        data['semantic_labels'], data['instance_labels'],
                        self.cfg.semantic_classes, self.cfg.instance_classes)
                if 'panoptic' in tasks:
                    ret['panoptic_preds'] = panoptic_fusion(
                        sem_preds, pred_instances, self.cfg,
                        self.cfg.semantic_classes, self.cfg.instance_classes)
        if stats is not None:
            stats.update(
                caps=caps, n_proposals=int(out.get('n_proposals', 0)),
                host_batch_ms=host.ms,
                # the batch's end to the postprocess: the forward, its
                # device work synchronised
                forward_ms=(post.start_ns - host.end_ns) * 1e-6,
                postprocess_ms=post.ms, n_points=n,
                n_voxels=int(batch.pyramid.levels[0].vox_valid.sum()),
                n_instances=len(pred_instances))
            if 'panoptic_preds' in ret:
                ids = ret['panoptic_preds'] >> 16
                stats['n_pasted'] = len(np.unique(ids[ids > 0]))
        return ret


def run_split(net, cfg, base_caps: Capacities, num_levels: int,
              logger=None, max_scenes: int | None = None, device='cuda',
              scene_stats: list | None = None):
    """Every scan of ``cfg.data.test`` (the first ``max_scenes``) through
    the runner of ``net`` (on ``device`` already): (the ``run_scene``
    results, the dataset).  ``scene_stats``, when given, receives each
    scan's ``run_scene`` stats."""
    dataset = build_dataset(cfg.data.test, logger)
    loader = build_dataloader(dataset, batch_size=1,
                              num_workers=cfg.dataloader.test.num_workers,
                              training=False)
    runner = InferenceRunner(net, cfg.model, base_caps, num_levels,
                             device=device)
    results = []
    for i, data in enumerate(loader):
        if max_scenes and i >= max_scenes:
            break
        st = {} if scene_stats is not None else None
        results.append(runner.run_scene(data, stats=st))
        if st is not None:
            scene_stats.append(st)
        if logger and i % 10 == 0:
            logger.info(f'scan {i}: {results[-1]["scan_id"]}')
    return results, dataset


def run_eval(net, cfg, base_caps: Capacities, num_levels: int, logger=None,
             max_scenes: int | None = None, device='cuda',
             scene_stats: list | None = None) -> dict:
    """``run_split``, then ``summarize``: a flat metric dict."""
    results, dataset = run_split(net, cfg, base_caps, num_levels, logger,
                                 max_scenes, device, scene_stats)
    return summarize(results, cfg, dataset, logger)


def summarize(results: list, cfg, dataset, logger=None) -> dict:
    """Instance AP / AP_50 / AP_25 (the ScanNet protocol), the point-wise
    mIoU, accuracy and offset MAE, and PQ (the SemanticKITTI protocol) of
    ``run_scene`` results, as the config's ``eval_tasks`` ask."""
    out = {}
    tasks = cfg.model.test_cfg.eval_tasks
    # the evaluator's gt size gate is the top-level eval_min_npoint (kitti
    # 50, stpls3d 10, else the protocol's default), not test_cfg.min_npoint,
    # which gates instance extraction
    eval_min_npoint = getattr_or(cfg, 'eval_min_npoint', None)
    if 'instance' in tasks and results and 'pred_instances' in results[0]:
        ev = ScanNetEval(dataset.CLASSES, min_npoint=eval_min_npoint)
        avgs = ev.evaluate([r['pred_instances'] for r in results],
                           [r['gt_instances'] for r in results])
        if logger:
            ev.print_results(avgs)
        out.update(AP=avgs['all_ap'], AP_50=avgs['all_ap_50%'],
                   AP_25=avgs['all_ap_25%'])
    if 'semantic' in tasks and results and 'semantic_preds' in results[0]:
        ignore = cfg.model.ignore_label
        sem_pred = np.concatenate([r['semantic_preds'] for r in results])
        sem_gt = np.concatenate([r['semantic_labels'] for r in results])
        out['mIoU'] = evaluate_semantic_miou(sem_pred, sem_gt, ignore,
                                             logger)
        out['Acc'] = evaluate_semantic_acc(sem_pred, sem_gt, ignore, logger)
        off_pred = np.concatenate([r['offset_preds'] for r in results])
        off_gt = np.concatenate([r['offset_labels'] for r in results])
        inst_gt = np.concatenate([r['instance_labels'] for r in results])
        out['Offset_MAE'] = evaluate_offset_mae(off_pred, off_gt, inst_gt,
                                                ignore, logger)
    if 'panoptic' in tasks and results and 'panoptic_preds' in results[0]:
        ev = PanopticEval(
            dataset.THING, dataset.STUFF,
            min_points=50 if eval_min_npoint is None else eval_min_npoint)
        pq = ev.evaluate([r['panoptic_preds'] for r in results],
                         [r['semantic_labels'] for r in results],
                         [r['instance_labels'] for r in results])
        if logger:
            logger.info(f'PQ: {pq["PQ"]:.1f}')
        out.update(PQ=pq['PQ'])
    return out
