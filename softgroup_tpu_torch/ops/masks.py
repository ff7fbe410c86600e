"""Proposal/instance IoU matrices and mask labels (counterpart of
``softgroup_tpu/ops/masks.py``: ``mask_iou_on_cluster``,
``mask_iou_on_pred``, ``mask_label``).

Proposals arrive as the static-capacity CSR (entry point indices, entry
segment ids, validity); counts are f32 ``index_add_`` scatters into a
flattened (proposals + 1, instances + 1) matrix whose dustbin row and
column drop.  The counts are small integers, so they are exact in any
summation order (``index_put_(accumulate=True)`` would sort its indices:
~150 ms a train step on the card, with every pad entry on one dustbin
cell).  Reference semantics kept: the +1e-5 IoU denominator, the
mask gate at sigmoid > 0.5, the argmax-gt scan over non-ignored instances
(``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does), and
-1 "ignore" labels below ``iou_thr``.
"""

from __future__ import annotations

import torch


def _intersections(entry_seg, entry_inst, weights, n_proposals: int,
                   n_instances: int) -> torch.Tensor:
    seg = entry_seg.long().clamp(0, n_proposals)
    inst = torch.where((entry_inst >= 0) & (entry_inst < n_instances),
                       entry_inst, n_instances).long()
    mat = torch.zeros(((n_proposals + 1) * (n_instances + 1),),
                      dtype=torch.float32, device=weights.device)
    mat.index_add_(0, seg * (n_instances + 1) + inst, weights)
    return mat.reshape(n_proposals + 1, -1)[:n_proposals, :n_instances]


def _entry_instances(entry_pt, instance_labels):
    return instance_labels[entry_pt.long().clamp(
        0, instance_labels.shape[0] - 1)]


def _iou(entry_pt, entry_seg, member, instance_labels, instance_pointnum,
         n_proposals: int) -> torch.Tensor:
    n_inst = instance_pointnum.shape[0]
    w = member.float()
    seg = torch.where(member, entry_seg, n_proposals)
    inter = _intersections(seg, _entry_instances(entry_pt, instance_labels),
                           w, n_proposals, n_inst)
    prop_total = torch.zeros((n_proposals + 1,), dtype=torch.float32,
                             device=w.device)
    prop_total.index_add_(0, seg.long().clamp(0, n_proposals), w)
    union = (prop_total[:n_proposals, None]
             + instance_pointnum[None, :].float() - inter)
    return inter / (union + 1e-5)


def mask_iou_on_cluster(entry_pt, entry_seg, entry_valid, instance_labels,
                        instance_pointnum, n_proposals: int) -> torch.Tensor:
    """(n_proposals, I) IoU between each proposal's point set and each gt
    instance."""
    return _iou(entry_pt, entry_seg, entry_valid, instance_labels,
                instance_pointnum, n_proposals)


def mask_iou_on_pred(entry_pt, entry_seg, entry_valid, instance_labels,
                     instance_pointnum, mask_scores_sigmoid,
                     n_proposals: int) -> torch.Tensor:
    """The same IoU with proposal membership gated by
    ``mask_scores_sigmoid > 0.5``."""
    return _iou(entry_pt, entry_seg, entry_valid & (mask_scores_sigmoid > 0.5),
                instance_labels, instance_pointnum, n_proposals)


def mask_label(entry_pt, entry_seg, entry_valid, instance_labels,
               instance_cls, proposals_iou, iou_thr: float,
               ignore_label: int = -100) -> torch.Tensor:
    """Per-entry binary mask target, or -1 = ignore: 1 where the entry's
    point belongs to its proposal's best non-ignored gt, when that IoU
    reaches ``iou_thr``."""
    n_proposals = proposals_iou.shape[0]
    allowed = (instance_cls != ignore_label)[None, :]
    iou_m = torch.where(allowed, proposals_iou,
                        torch.zeros_like(proposals_iou))
    max_ind = torch.argmax(iou_m, dim=1)
    max_iou = torch.gather(iou_m, 1, max_ind[:, None])[:, 0]
    seg = entry_seg.long().clamp(0, n_proposals - 1)
    assigned = max_iou[seg] >= iou_thr
    member = (_entry_instances(entry_pt, instance_labels)
              == max_ind[seg]).float()
    return torch.where(assigned & entry_valid, member,
                       torch.full_like(member, -1.0))
