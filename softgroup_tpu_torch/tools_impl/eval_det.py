"""Axis-aligned 3-D box detection AP from instance masks (counterpart of
``tools/eval_det.py``): the VOC protocol over boxes derived from each
instance's points, at an IoU threshold (0.25 by default).

    python -m softgroup_tpu_torch.tools_impl.eval_det results/ \
        [--iou 0.25] [--use-07-metric]

``results/`` is what the test CLI's ``--out`` wrote for an instance
config (``coords/``, ``pred_instance/``, ``gt_instance/``).  Library use:
``eval_det(pred_all, gt_all, ovthresh=0.25)`` with ``pred_all[scan] =
[(class, bbox (6,), score), ...]`` and ``gt_all[scan] = [(class, bbox),
...]``; a bbox is (xmin, ymin, zmin, xmax, ymax, zmax).
"""

from __future__ import annotations

import argparse
import os.path as osp
from glob import glob

import numpy as np

from ..util.rle import rle_decode


def box_iou_aabb(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two axis-aligned boxes (xmin,ymin,zmin,xmax,ymax,zmax)."""
    lo = np.maximum(a[:3], b[:3])
    hi = np.minimum(a[3:], b[3:])
    inter = np.prod(np.maximum(hi - lo, 0.0))
    va = np.prod(np.maximum(a[3:] - a[:3], 0.0))
    vb = np.prod(np.maximum(b[3:] - b[:3], 0.0))
    union = va + vb - inter
    return float(inter / union) if union > 0 else 0.0


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    """VOC AP.  use_07_metric: the VOC-2007 11-point interpolation;
    default: exact area under the interpolated PR curve (reference
    `tools/eval_det.py:10-41`)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            sel = rec >= t
            p = float(np.max(prec[sel])) if np.any(sel) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_det_cls(pred: dict, gt: dict, ovthresh: float = 0.25,
                 use_07_metric: bool = False, get_iou_func=box_iou_aabb):
    """AP for one class.  pred[scan] = [(bbox, score)], gt[scan] = [bbox].

    get_iou_func is pluggable like the reference's (`eval_det_cls`,
    tools/eval_det.py:74-158) — pass a sphere IoU for spherical eval."""
    npos = sum(len(v) for v in gt.values())
    matched = {scan: np.zeros(len(boxes), bool) for scan, boxes in gt.items()}

    records = []  # (score, scan, bbox)
    for scan, entries in pred.items():
        for bbox, score in entries:
            records.append((float(score), scan, np.asarray(bbox)))
    records.sort(key=lambda r: -r[0])

    tp = np.zeros(len(records))
    fp = np.zeros(len(records))
    for i, (_, scan, bb) in enumerate(records):
        gts = gt.get(scan, [])
        best, best_j = -1.0, -1
        for j, gbb in enumerate(gts):
            iou = get_iou_func(bb, np.asarray(gbb))
            if iou > best:
                best, best_j = iou, j
        if best > ovthresh and not matched[scan][best_j]:
            tp[i] = 1
            matched[scan][best_j] = True
        else:
            fp[i] = 1
    if npos == 0:
        return 0.0, 0.0, 0.0
    cum_fp = np.cumsum(fp)
    cum_tp = np.cumsum(tp)
    rec = cum_tp / npos
    prec = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def _group_by_class(pred_all: dict, gt_all: dict):
    pred, gt = {}, {}
    for scan, entries in pred_all.items():
        for cls, bbox, score in entries:
            pred.setdefault(cls, {}).setdefault(scan, []).append((bbox, score))
    for scan, entries in gt_all.items():
        for cls, bbox in entries:
            gt.setdefault(cls, {}).setdefault(scan, []).append(bbox)
    return pred, gt


def eval_det(pred_all: dict, gt_all: dict, ovthresh: float = 0.25,
             use_07_metric: bool = False, get_iou_func=box_iou_aabb):
    """Per-class AP over all scans; returns {classname: ap}."""
    pred, gt = _group_by_class(pred_all, gt_all)
    aps = {}
    for cls in gt:
        _, _, ap = eval_det_cls(pred.get(cls, {}), gt[cls], ovthresh,
                                use_07_metric, get_iou_func)
        aps[cls] = ap
    return aps


def eval_sphere(pred_all: dict, gt_all: dict, ovthresh: float = 0.25,
                use_07_metric: bool = False, get_iou_func=box_iou_aabb):
    """Full-protocol variant returning (rec, prec, ap) per class, with
    classes never predicted scoring 0 — reference `eval_sphere`
    (tools/eval_det.py:213-264; there the only differences from eval_det
    are the worker pool and the missing-class zeros — class evals here are
    cheap numpy loops, so no pool is needed)."""
    pred, gt = _group_by_class(pred_all, gt_all)
    rec, prec, ap = {}, {}, {}
    for cls in gt:
        if cls in pred:
            rec[cls], prec[cls], ap[cls] = eval_det_cls(
                pred[cls], gt[cls], ovthresh, use_07_metric, get_iou_func)
        else:
            rec[cls], prec[cls], ap[cls] = 0, 0, 0
    return rec, prec, ap


def boxes_from_instances(coords: np.ndarray, instances: list,
                         decode=None) -> list:
    """Convert per-scan instance masks to (classname, bbox, score) tuples."""
    out = []
    for inst in instances:
        mask = inst['pred_mask']
        if isinstance(mask, dict):
            mask = rle_decode(mask)
        pts = coords[np.asarray(mask, bool)]
        if len(pts) == 0:
            continue
        bbox = np.concatenate([pts.min(0), pts.max(0)])
        out.append((int(inst['label_id']), bbox, float(inst['conf'])))
    return out


def load_boxes(results: str) -> tuple:
    """(pred_all, gt_all) of every scan under ``results/coords``: a
    predicted box a non-empty mask of ``pred_instance/<scan>.txt`` (its
    label and score), a gt box an encoded id of ``gt_instance/<scan>.txt``
    of at least 1000 (an annotated class)."""
    pred_all, gt_all = {}, {}
    for f in sorted(glob(osp.join(results, 'coords', '*.npy'))):
        scan = osp.splitext(osp.basename(f))[0]
        coords = np.load(f)
        entries = []
        pred_file = osp.join(results, 'pred_instance', f'{scan}.txt')
        with open(pred_file) as fh:
            for line in fh:
                rel, label_id, conf = line.split()
                mask = np.loadtxt(
                    osp.join(results, 'pred_instance', rel)).astype(bool)
                pts = coords[mask]
                if not len(pts):
                    continue
                entries.append((int(label_id),
                                np.concatenate([pts.min(0), pts.max(0)]),
                                float(conf)))
        pred_all[scan] = entries
        gt_ids = np.loadtxt(
            osp.join(results, 'gt_instance', f'{scan}.txt')).astype(
                np.int64)
        gts = []
        for gid in np.unique(gt_ids):
            if gid < 1000:
                continue
            pts = coords[gt_ids == gid]
            gts.append((int(gid // 1000),
                        np.concatenate([pts.min(0), pts.max(0)])))
        gt_all[scan] = gts
    return pred_all, gt_all


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='box AP from saved masks')
    p.add_argument('results', help='directory written by the test CLI --out')
    p.add_argument('--iou', type=float, default=0.25)
    p.add_argument('--use-07-metric', action='store_true',
                   help='VOC-2007 11-point AP interpolation')
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the tool on ``argv`` (None: ``sys.argv``): prints each class's
    AP and the mAP, and returns ``aps`` (class -> AP), ``mAP`` and the
    predicted and gt box counts (``n_pred``, ``n_gt``)."""
    args = parse_args(argv)
    pred_all, gt_all = load_boxes(args.results)
    _, _, aps = eval_sphere(pred_all, gt_all, args.iou,
                            use_07_metric=args.use_07_metric)
    for cls, ap in sorted(aps.items()):
        print(f'class {cls}: AP@{args.iou} = {ap:.4f}')
    m_ap = float(np.mean(list(aps.values())))
    print(f'mAP@{args.iou} = {m_ap:.4f}')
    return dict(aps=aps, mAP=m_ap,
                n_pred=sum(len(v) for v in pred_all.values()),
                n_gt=sum(len(v) for v in gt_all.values()))


if __name__ == '__main__':
    main()
