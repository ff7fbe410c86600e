"""Point-wise metrics: semantic accuracy, class-wise mIoU, offset MAE — a
copy of ``softgroup_tpu/evaluation/point_wise_eval.py`` (the protocol of
the reference's ``softgroup/evaluation/point_wise_eval.py:4-44``)."""

from __future__ import annotations

import numpy as np


def evaluate_semantic_acc(pred: np.ndarray, gt: np.ndarray,
                          ignore_label: int = -100, logger=None) -> float:
    mask = gt != ignore_label
    acc = float((pred[mask] == gt[mask]).sum()) / max(mask.sum(), 1) * 100
    if logger:
        logger.info(f'Acc: {acc:.1f}')
    return acc


def evaluate_semantic_miou(pred: np.ndarray, gt: np.ndarray,
                           ignore_label: int = -100, logger=None) -> float:
    mask = gt != ignore_label
    pred, gt = pred[mask], gt[mask]
    ious = []
    for c in np.unique(gt):
        inter = ((pred == c) & (gt == c)).sum()
        union = ((pred == c) | (gt == c)).sum()
        ious.append(inter / max(union, 1) * 100)
    miou = float(np.mean(ious)) if ious else 0.0
    if logger:
        logger.info(f'mIoU: {miou:.1f}')
    return miou


def evaluate_offset_mae(pred_offsets: np.ndarray, gt_offsets: np.ndarray,
                        gt_instance_labels: np.ndarray,
                        ignore_label: int = -100, logger=None) -> float:
    mask = gt_instance_labels != ignore_label
    mae = np.abs(pred_offsets[mask] - gt_offsets[mask]).sum()
    mae /= max(mask.sum(), 1)
    if logger:
        logger.info(f'Offset MAE: {mae:.3f}')
    return float(mae)
