"""Single-scene inference runner (counterpart of
``softgroup_tpu/tools_impl/test_runner.py``: ``bucketed_caps`` and
``InferenceRunner``).

A request is ``run_scene(data)`` on one collated scan: the host batch at
per-scene bucketed capacities (``build_batch``, native host geometry), the
device forward (``test_forward``, or ``test_forward_plus`` when
``test_cfg.lvl_fusion`` is set), then the host postprocess in the scan's
original point order.  The evaluators (``run_eval`` / ``summarize``) and
panoptic fusion are not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data.padding import build_scene_batch, round_capacity
from ..evaluation.postprocess import get_gt_instances, get_instances, to_numpy
from ..model.softgroup import Capacities
from ..ops.geometry import host_geometry


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
        proposal count and the host clock of each stage in ms
        (``host_batch_ms``, ``forward_ms`` with the device synchronised,
        ``postprocess_ms``: the copy to the host and the instances)."""
        tasks = self.cfg.test_cfg.eval_tasks
        if 'panoptic' in tasks:
            raise NotImplementedError(
                'panoptic fusion waits for the pair_keys grouping slice '
                '(ops/keys.py) and is not ported')
        scan_id = data['scan_ids'][0]
        n = len(data['coords'])
        t0 = time.perf_counter()
        batch, caps = self.build_batch(data)
        t1 = time.perf_counter()
        out = self.forward(batch, caps)
        if stats is not None and self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
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
            # get_instances reads point-level fields straight from `out`
            out['semantic_preds'] = np.concatenate(
                [sem_preds, out['semantic_preds'][n:]])
            if 'entry_pt' in out and not self.lvl_fusion:
                # proposal entries index points in sorted order (under
                # lvl_fusion they index voxels and stay as they are)
                ev = out['entry_valid']
                pts = perm[np.clip(out['entry_pt'], 0, n - 1)]
                out['entry_pt'] = np.where(ev, pts, out['entry_pt'])

        ret = dict(scan_id=scan_id)
        if 'semantic' in tasks:
            ret.update(
                semantic_labels=data['semantic_labels'],
                instance_labels=data['instance_labels'],
                coords_float=data['coords_float'],
                color_feats=data['feats'],
                semantic_preds=sem_preds,
                offset_preds=unperm(out['pt_offsets'][:n]),
                offset_labels=data['pt_offset_labels'])
        if not self.net.semantic_only and 'instance' in tasks:
            if self.lvl_fusion:
                # masks live on voxels: expand through the un-permuted p2v
                p2v = unperm(batch.pyramid.p2v[:n].cpu().numpy())
                n_vox = int(batch.pyramid.levels[0].vox_valid.sum())
                ret['pred_instances'] = get_instances(
                    scan_id, out, n_vox, self.cfg, v2p_map=p2v)
            else:
                ret['pred_instances'] = get_instances(scan_id, out, n,
                                                      self.cfg)
            ret['gt_instances'] = get_gt_instances(
                data['semantic_labels'], data['instance_labels'],
                self.cfg.semantic_classes, self.cfg.instance_classes)
        if stats is not None:
            stats.update(
                caps=caps, n_proposals=int(out.get('n_proposals', 0)),
                host_batch_ms=(t1 - t0) * 1e3, forward_ms=(t2 - t1) * 1e3,
                postprocess_ms=(time.perf_counter() - t2) * 1e3)
        return ret
