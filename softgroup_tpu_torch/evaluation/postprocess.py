"""Host-side inference postprocessing: the per-scan instance list from the
outputs of ``SoftGroupNet.test_forward`` / ``test_forward_plus``, the gt
encoding of the instance evaluator and the panoptic fusion of instances
over the semantic predictions (numpy copies of
``softgroup_tpu/evaluation/postprocess.py``: ``get_instances``,
``get_gt_instances``, ``panoptic_fusion``).

``out`` holds numpy arrays (``to_numpy`` converts a dict of tensors); entries
are CSR-sorted by proposal id.
"""

from __future__ import annotations

import numpy as np

from ..util.rle import rle_decode, rle_encode


def to_numpy(out: dict) -> dict:
    """Device outputs -> numpy (one host copy per array)."""
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def get_instances(scan_id: str, out: dict, n_points: int, cfg,
                  v2p_map: np.ndarray | None = None) -> list[dict]:
    """Build the per-scan instance list from device outputs.

    out: dict from test_forward (numpy-converted); entries are CSR-sorted by
    proposal id.  n_points: real (unpadded) point count of the scan.
    """
    cls_scores = np.asarray(out['cls_scores'])        # (Pmax, K+1) softmaxed
    iou_scores = np.asarray(out['iou_scores'])        # (Pmax, K+1)
    mask_scores = np.asarray(out['mask_scores'])      # (S, K+1)
    entry_pt = np.asarray(out['entry_pt'])
    entry_seg = np.asarray(out['entry_seg'])
    entry_valid = np.asarray(out['entry_valid'])
    n_props = int(out['n_proposals'])
    k = cls_scores.shape[1] - 1

    lvl_fusion = v2p_map is not None
    # semantic_preds are always point-level (test_forward_plus gathers them
    # through p2v already); sem2ins masks therefore never need expansion
    n_real_points = len(v2p_map) if lvl_fusion else n_points
    semantic_pred = np.asarray(out['semantic_preds'])[:n_real_points]

    # per-proposal CSR ranges (entries are sorted by proposal id)
    ev = entry_valid
    seg = entry_seg[ev]
    pts = entry_pt[ev]
    msk = mask_scores[ev]
    order = np.argsort(seg, kind='stable')
    seg, pts, msk = seg[order], pts[order], msk[order]
    starts = np.searchsorted(seg, np.arange(n_props))
    ends = np.searchsorted(seg, np.arange(n_props) + 1)

    instances = []
    for i in range(k):
        if i in cfg.sem2ins_classes:
            mask = (semantic_pred == i).astype(np.uint8)
            instances.append(dict(scan_id=scan_id, label_id=i + 1, conf=1.0,
                                  pred_mask=rle_encode(mask)))
            continue
        score = cls_scores[:n_props, i] * np.clip(iou_scores[:n_props, i],
                                                  0, 1)
        keep = cls_scores[:n_props, i] > cfg.test_cfg.cls_score_thr
        gate = msk[:, i] > cfg.test_cfg.mask_score_thr
        for p in np.nonzero(keep)[0]:
            sel = slice(starts[p], ends[p])
            ppts = pts[sel][gate[sel]]
            if lvl_fusion:
                mask = np.zeros(n_points, np.uint8)
                mask[ppts[ppts < n_points]] = 1
                mask = mask[v2p_map]
                npoint = int(mask.sum())
            else:
                ppts = ppts[ppts < n_points]
                npoint = len(ppts)
                mask = None
            if npoint < cfg.test_cfg.min_npoint:
                continue
            if mask is None:
                mask = np.zeros(n_points, np.uint8)
                mask[ppts] = 1
            instances.append(dict(scan_id=scan_id, label_id=i + 1,
                                  conf=float(score[p]),
                                  pred_mask=rle_encode(mask)))
    return instances


def get_gt_instances(semantic_labels: np.ndarray, instance_labels: np.ndarray,
                     semantic_classes: int, instance_classes: int
                     ) -> np.ndarray:
    """gt as ``sem * 1000 + inst``, 0 = ignored: semantic ids shifted so
    the instance classes start at 1."""
    label_shift = semantic_classes - instance_classes
    sem = semantic_labels - label_shift + 1
    sem = np.where(sem < 0, 0, sem)
    inst = instance_labels + 1
    gt = sem.astype(np.int64) * 1000 + inst
    gt[inst < 0] = 0  # ignored instances (label -100)
    return gt


def panoptic_fusion(semantic_preds: np.ndarray, instance_preds: list[dict],
                    cfg, semantic_classes: int, instance_classes: int,
                    thing_start: int | None = None) -> np.ndarray:
    """Panoptic codes ``(cls & 0xFFFF) | (id << 16)`` (uint32) of a scan:
    instances pasted over the semantic predictions by descending score,
    an instance whose mask overlaps the pasted points by more than
    ``cfg.test_cfg.panoptic_skip_iou`` skipped; a thing-class point that
    no instance took gets class ``semantic_classes`` (ignore) and id 0.

    thing_start defaults to semantic_classes - instance_classes (the stuff
    classes take the low ids): 19 - 8 = 11 for SemanticKITTI."""
    if thing_start is None:
        thing_start = semantic_classes - instance_classes
    cls_offset = semantic_classes - instance_classes - 1
    pan_cls = semantic_preds.astype(np.uint32).copy()
    pan_ids = np.zeros_like(pan_cls)

    order = np.argsort([x['conf'] for x in instance_preds])[::-1]
    pasted = np.zeros(len(semantic_preds), bool)
    pid = 1
    for i in order:
        inst = instance_preds[i]
        mask = rle_decode(inst['pred_mask']).astype(bool)
        inter = (mask & pasted).sum()
        if inter / (mask.sum() + 1e-5) > cfg.test_cfg.panoptic_skip_iou:
            continue
        paste = mask & ~pasted
        pan_cls[paste] = inst['label_id'] + cls_offset
        pan_ids[paste] = pid
        pasted |= paste
        pid += 1

    ignore = (pan_cls >= thing_start) & (pan_ids == 0)
    out = (pan_cls & 0xFFFF) | (pan_ids << np.uint32(16))
    out[ignore] = semantic_classes
    return out.astype(np.uint32)
