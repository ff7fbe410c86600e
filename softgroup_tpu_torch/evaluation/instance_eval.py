"""Instance-segmentation AP under the ScanNet benchmark protocol: a copy of
``softgroup_tpu/evaluation/instance_eval.py`` (numpy, host).

Protocol-equivalent to the reference evaluator (`softgroup/evaluation/
instance_eval.py`, itself derived from the public ScanNet BenchmarkScripts),
re-implemented vectorized: per-scan pred-gt intersections are computed with
one bincount per prediction instead of per-(pred, gt) mask scans, and scans
are processed in a worker pool.

Protocol summary (parity-critical details):
  * gt encoding per point: ``sem_class_id * 1000 + instance_id`` with 0 =
    unannotated (`get_gt_instances`, softgroup.py:641-653).
  * gt instances participate if their encoded id >= 1000 and their size >=
    min_region_size (default 100).
  * IoU thresholds 0.50:0.05:0.95 plus 0.25; AP = step-integrated PR curve;
    the headline AP averages the 0.5:0.95 band (`compute_averages`).
  * Greedy matching: gts in ascending id order consume their first unvisited
    overlapping pred with iou > thr; extra matching preds for an already
    matched gt contribute false positives at the lower confidence; unmatched
    gts are hard false negatives; unmatched preds are false positives unless
    their overlap with void/small/unlabeled regions exceeds the threshold.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Sequence

import numpy as np

from ..util.rle import rle_decode

IOUS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)


class ScanNetEval:

    def __init__(self, class_labels: Sequence[str], min_npoint: int | None = None,
                 iou_type=None, use_label: bool = True):
        self.class_labels = list(class_labels)
        self.class_ids = np.arange(len(class_labels)) + 1
        self.min_region_size = int(min_npoint) if min_npoint else 100
        self.use_label = use_label
        self.eval_class_labels = (self.class_labels if use_label
                                  else ['class_agnostic'])

    # ---------------- per-scan association ----------------

    def assign_instances_for_scan(self, preds: list, gts: np.ndarray):
        """Compute, per evaluated class, the gt table and pred table with the
        full iou/intersection matrices for one scan."""
        gts = np.asarray(gts).astype(np.int64)
        n_cls = len(self.class_labels)

        # gt instance table: encoded ids, sizes, class index
        uniq, counts = np.unique(gts, return_counts=True)
        keep = uniq >= 1000  # encoded instances of annotated classes
        gt_ids = uniq[keep]
        gt_sizes = counts[keep]
        gt_cls = gt_ids // 1000 - 1           # 0-based class index
        valid_gt = (gt_cls >= 0) & (gt_cls < n_cls)
        gt_ids, gt_sizes, gt_cls = gt_ids[valid_gt], gt_sizes[valid_gt], \
            gt_cls[valid_gt]
        # map each point to a row in the gt table (or -1)
        gt_row = np.full(len(gts), -1, np.int64)
        for row, gid in enumerate(gt_ids):
            gt_row[gts == gid] = row
        void_mask = ~np.isin(gts // 1000, self.class_ids)
        small_gt = gt_sizes < self.min_region_size

        per_class = {}
        for li in range(len(self.eval_class_labels)):
            if self.use_label:
                grows = np.nonzero(gt_cls == li)[0]
            else:
                grows = np.arange(len(gt_ids))
            per_class[li] = dict(
                gt_ids=gt_ids[grows], gt_sizes=gt_sizes[grows],
                gt_small=small_gt[grows], gt_rows=grows,
                pred_conf=[], pred_size=[], pred_void=[], inter=[])

        for pred in preds:
            if self.use_label:
                label_id = int(pred['label_id'])
                li = label_id - 1
                if li < 0 or li >= n_cls:
                    continue
            else:
                li = 0
            mask = pred['pred_mask']
            if isinstance(mask, dict):
                mask = rle_decode(mask)
            mask = np.asarray(mask) != 0
            size = int(mask.sum())
            if size < self.min_region_size:
                continue
            entry = per_class[li]
            rows = gt_row[mask]
            inter_all = np.bincount(rows[rows >= 0], minlength=len(gt_ids)) \
                if size else np.zeros(len(gt_ids), np.int64)
            entry['pred_conf'].append(float(pred['conf']))
            entry['pred_size'].append(size)
            entry['pred_void'].append(int(void_mask[mask].sum()))
            entry['inter'].append(inter_all[entry['gt_rows']])

        out = {}
        for li, e in per_class.items():
            npred = len(e['pred_conf'])
            ngt = len(e['gt_ids'])
            inter = (np.stack(e['inter']) if npred else
                     np.zeros((0, ngt), np.int64))
            sizes = np.asarray(e['pred_size'], np.int64)
            union = sizes[:, None] + e['gt_sizes'][None, :] - inter
            iou = inter / np.maximum(union, 1)
            # void-proportion numerator: void + unlabeled-group + small-gt
            # intersections (evaluate_matches FP-ignore rule)
            extra = inter[:, e['gt_small']].sum(1) if npred else \
                np.zeros(0, np.int64)
            out[li] = dict(
                gt_sizes=e['gt_sizes'], gt_small=e['gt_small'],
                conf=np.asarray(e['pred_conf'], np.float64),
                size=sizes, iou=iou, inter=inter,
                void=np.asarray(e['pred_void'], np.int64), extra_ignore=extra)
        return out

    # ---------------- PR accumulation over scans ----------------

    def _pr_for_class(self, scans: list, li: int, iou_thr: float):
        y_true, y_score = [], []
        hard_fn = 0
        has_gt = has_pred = False
        for scan in scans:
            e = scan[li]
            ngt_all = len(e['gt_sizes'])
            big = ~e['gt_small']
            if big.any():
                has_gt = True
            if len(e['conf']):
                has_pred = True
            visited = np.zeros(len(e['conf']), bool)
            matched = np.zeros(ngt_all, bool)
            scores = np.full(ngt_all, -np.inf)
            # greedy per-gt matching in gt order (only big gts participate)
            for g in range(ngt_all):
                if not big[g]:
                    continue
                found = False
                # the benchmark iterates preds in insertion order and
                # consumes every pred with iou > thr for this gt
                for p in range(len(e['conf'])):
                    if visited[p] or e['iou'][p, g] <= iou_thr:
                        continue
                    c = e['conf'][p]
                    if matched[g]:
                        # duplicate: lower-confidence one becomes a FP
                        y_true.append(0.0)
                        y_score.append(min(scores[g], c))
                        scores[g] = max(scores[g], c)
                    else:
                        matched[g] = True
                        scores[g] = c
                        visited[p] = True
                        found = True
                if not found:
                    hard_fn += 1
            y_true.extend([1.0] * int(matched.sum()))
            y_score.extend(scores[matched].tolist())
            # unmatched predictions -> FP unless mostly-ignored; overlap with
            # a small gt above thr also shields a pred (it stays ignored)
            for p in range(len(e['conf'])):
                if (e['iou'][p] > iou_thr).any():
                    continue
                num_ignore = e['void'][p] + e['extra_ignore'][p]
                if num_ignore / e['size'][p] <= iou_thr:
                    y_true.append(0.0)
                    y_score.append(e['conf'][p])
        if not has_gt:
            return np.nan, np.nan
        if not has_pred:
            return 0.0, 0.0
        return _average_precision(np.asarray(y_true), np.asarray(y_score),
                                  hard_fn)

    def evaluate(self, pred_list: list, gt_list: list, nproc: int | None = None):
        """pred_list: per scan, list of dicts(scan_id, label_id, conf,
        pred_mask); gt_list: per scan, per-point encoded gt ids."""
        nproc = nproc or mp.cpu_count()
        if nproc > 1 and len(pred_list) > 1:
            with mp.Pool(min(nproc, len(pred_list))) as pool:
                scans = pool.starmap(self.assign_instances_for_scan,
                                     zip(pred_list, gt_list))
        else:
            scans = [self.assign_instances_for_scan(p, g)
                     for p, g in zip(pred_list, gt_list)]

        ncls = len(self.eval_class_labels)
        ap = np.zeros((ncls, len(IOUS)))
        rc = np.zeros((ncls, len(IOUS)))
        for li in range(ncls):
            for oi, thr in enumerate(IOUS):
                ap[li, oi], rc[li, oi] = self._pr_for_class(scans, li, thr)
        return self._averages(ap, rc)

    def _averages(self, aps, rcs):
        o50 = np.isclose(IOUS, 0.5)
        o25 = np.isclose(IOUS, 0.25)
        main = ~o25
        avg = dict(
            all_ap=np.nanmean(aps[:, main]),
            **{'all_ap_50%': np.nanmean(aps[:, o50]),
               'all_ap_25%': np.nanmean(aps[:, o25]),
               'all_rc': np.nanmean(rcs[:, main]),
               'all_rc_50%': np.nanmean(rcs[:, o50]),
               'all_rc_25%': np.nanmean(rcs[:, o25])},
            classes={})
        for li, name in enumerate(self.eval_class_labels):
            avg['classes'][name] = {
                'ap': np.average(aps[li, main]),
                'ap50%': np.average(aps[li, o50]),
                'ap25%': np.average(aps[li, o25]),
                'rc': np.average(rcs[li, main]),
                'rc50%': np.average(rcs[li, o50]),
                'rc25%': np.average(rcs[li, o25]),
            }
        return avg

    def print_results(self, avgs):
        cols = ['AP', 'AP_50%', 'AP_25%', 'AR', 'RC_50%', 'RC_25%']
        keys = ['ap', 'ap50%', 'ap25%', 'rc', 'rc50%', 'rc25%']
        print('#' * 64)
        print('{:<15}:'.format('what') + ''.join(f'{c:>8}' for c in cols))
        print('#' * 64)
        for name in self.eval_class_labels:
            c = avgs['classes'][name]
            print('{:<15}:'.format(name)
                  + ''.join('{:>8.3f}'.format(c[k]) for k in keys))
        print('-' * 64)
        vals = [avgs['all_ap'], avgs['all_ap_50%'], avgs['all_ap_25%'],
                avgs['all_rc'], avgs['all_rc_50%'], avgs['all_rc_25%']]
        print('{:<15}:'.format('average')
              + ''.join('{:>8.3f}'.format(v) for v in vals))
        print('#' * 64)


def _average_precision(y_true, y_score, hard_fn):
    """Step-integrated AP exactly as the benchmark computes it: PR points at
    unique score thresholds (scores ascending), first-point recall reported,
    trapezoid-free step integration via the [-0.5, 0, 0.5] convolution."""
    order = np.argsort(y_score)
    ys = y_score[order]
    yt = y_true[order]
    cum = np.cumsum(yt)
    thresholds, first_idx = np.unique(ys, return_index=True)
    num = len(ys)
    num_true = cum[-1] if num else 0
    cum_pad = np.append(cum, 0)

    precision = np.zeros(len(first_idx) + 1)
    recall = np.zeros(len(first_idx) + 1)
    for res, idx in enumerate(first_idx):
        below = cum_pad[idx - 1]  # trues strictly below this threshold
        tp = num_true - below
        fp = num - idx - tp
        fn = below + hard_fn
        precision[res] = tp / (tp + fp)
        recall[res] = tp / (tp + fn)
    rc_first = recall[0] if len(first_idx) else 0.0
    precision[-1] = 1.0
    recall[-1] = 0.0
    r_conv = np.concatenate([[recall[0]], recall, [0.0]])
    step = np.convolve(r_conv, [-0.5, 0, 0.5], 'valid')
    return float(np.dot(precision, step)), float(rc_first)
