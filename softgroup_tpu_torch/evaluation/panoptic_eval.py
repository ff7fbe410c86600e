"""Panoptic quality (PQ / SQ / RQ) under the SemanticKITTI protocol: a copy
of ``softgroup_tpu/evaluation/panoptic_eval.py`` (itself the reference's
``softgroup/evaluation/panoptic_eval.py``, after the public
semantic-kitti-api evaluation).

Per scan and class, segments match at IoU > 0.5 through the packed combo
``pred + offset * gt`` (``offset`` 2**32); an unmatched segment counts as a
false positive or negative only with ``min_points`` points or more.  TP,
IoU sums, FP and FN add up over the scans; PQ-dagger takes the semantic IoU
for the stuff classes.

Predictions are packed panoptic codes ((cls & 0xFFFF) | (id << 16)): the
whole code is the predicted instance id.  The gt instance ids are the
scan's dense labels with the ignore label below zero; points whose gt
class is the ignore label are dropped before any count.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Sequence

import numpy as np


class PanopticEval:

    def __init__(self, thing_classes: Sequence[str],
                 stuff_classes: Sequence[str], min_points: int = 50,
                 ignore_label: int = -100, offset: int = 2 ** 32):
        self.thing_classes = list(thing_classes)
        self.stuff_classes = list(stuff_classes)
        self.classes = self.stuff_classes + self.thing_classes
        self.n_classes = len(self.classes)
        self.min_points = min_points
        self.ignore_label = ignore_label
        self.offset = offset
        self.eps = 1e-15

    def evaluate_single(self, panoptic_pred, sem_gt, inst_gt):
        """Per-class (tp, iou_sum, fp, fn, seen, correct, positive) of one
        scan."""
        n_cls = self.n_classes
        tp = np.zeros(n_cls, np.int64)
        iou_sum = np.zeros(n_cls, np.float64)
        fp = np.zeros(n_cls, np.int64)
        fn = np.zeros(n_cls, np.int64)
        seen = np.zeros(n_cls, np.int64)
        correct = np.zeros(n_cls, np.int64)
        positive = np.zeros(n_cls, np.int64)

        pred_sem = (panoptic_pred & 0xFFFF).astype(np.int64)
        pred_inst = panoptic_pred.astype(np.int64) + 1
        gt_inst = np.where(inst_gt == self.ignore_label, -1,
                           inst_gt).astype(np.int64) + 2

        keep = sem_gt != self.ignore_label
        pred_sem, gt_sem = pred_sem[keep], sem_gt[keep].astype(np.int64)
        pred_inst, gt_inst = pred_inst[keep], gt_inst[keep]

        for cl in range(n_cls):
            gmask = gt_sem == cl
            pmask = pred_sem == cl
            seen[cl] = gmask.sum()
            positive[cl] = pmask.sum()
            correct[cl] = (gmask & pmask).sum()

            p_in = np.where(pmask, pred_inst, 0)
            g_in = np.where(gmask, gt_inst, 0)
            p_ids, p_counts = np.unique(p_in[p_in > 0], return_counts=True)
            g_ids, g_counts = np.unique(g_in[g_in > 0], return_counts=True)

            both = (p_in > 0) & (g_in > 0)
            combo = p_in[both] + self.offset * g_in[both]
            c_ids, c_counts = np.unique(combo, return_counts=True)
            cg = c_ids // self.offset
            cp = c_ids % self.offset
            g_area = g_counts[np.searchsorted(g_ids, cg)]
            p_area = p_counts[np.searchsorted(p_ids, cp)]
            iou = c_counts / (g_area + p_area - c_counts).astype(np.float64)

            match = iou > 0.5
            tp[cl] = match.sum()
            iou_sum[cl] = iou[match].sum()
            g_matched = np.isin(g_ids, cg[match])
            p_matched = np.isin(p_ids, cp[match])
            fn[cl] = ((g_counts >= self.min_points) & ~g_matched).sum()
            fp[cl] = ((p_counts >= self.min_points) & ~p_matched).sum()
        return tp, iou_sum, fp, fn, seen, correct, positive

    def evaluate(self, panoptic_preds, sem_labels, inst_labels,
                 nproc: int | None = None, verbose: bool = True) -> dict:
        """PQ, PQ_dagger, SQ, RQ, mIoU, PQ_th, PQ_st (in %) and their
        per-class lists over the scans; ``nproc`` worker processes (None:
        one a CPU; 1 or a single scan: this process)."""
        nproc = nproc or mp.cpu_count()
        if nproc > 1 and len(panoptic_preds) > 1:
            with mp.Pool(min(nproc, len(panoptic_preds))) as pool:
                parts = pool.starmap(
                    self.evaluate_single,
                    zip(panoptic_preds, sem_labels, inst_labels))
        else:
            parts = [self.evaluate_single(p, s, i)
                     for p, s, i in zip(panoptic_preds, sem_labels,
                                        inst_labels)]
        tp, iou_sum, fp, fn, seen, correct, positive = (
            np.stack(x).sum(0) for x in zip(*parts))

        sem_iou = correct / np.maximum(
            (seen + positive - correct).astype(np.float64), self.eps)
        sq = iou_sum / np.maximum(tp.astype(np.float64), self.eps)
        rq = tp / np.maximum(tp + 0.5 * fp + 0.5 * fn, self.eps)
        pq = sq * rq
        pq_dagger = pq.copy()
        n_stuff = len(self.stuff_classes)
        pq_dagger[:n_stuff] = sem_iou[:n_stuff]

        out = dict(
            PQ=float(pq.mean() * 100),
            PQ_dagger=float(pq_dagger.mean() * 100),
            SQ=float(sq.mean() * 100),
            RQ=float(rq.mean() * 100),
            mIoU=float(sem_iou.mean() * 100),
            PQ_th=float(pq[n_stuff:].mean() * 100) if self.thing_classes
            else float('nan'),
            PQ_st=float(pq[:n_stuff].mean() * 100) if n_stuff
            else float('nan'),
            per_class=dict(pq=(pq * 100).tolist(), sq=(sq * 100).tolist(),
                           rq=(rq * 100).tolist(),
                           iou=(sem_iou * 100).tolist()),
        )
        if verbose:
            self.print_results(out)
        return out

    def print_results(self, out: dict):
        print('#' * 60)
        print(f'{"what":<14}:{"PQ":>8}{"SQ":>8}{"RQ":>8}{"mIoU":>8}')
        print('#' * 60)
        pc = out['per_class']
        for i, name in enumerate(self.classes):
            print(f'{name:<14}:{pc["pq"][i]:>8.1f}{pc["sq"][i]:>8.1f}'
                  f'{pc["rq"][i]:>8.1f}{pc["iou"][i]:>8.1f}')
        print('-' * 60)
        print(f'{"average":<14}:{out["PQ"]:>8.1f}{out["SQ"]:>8.1f}'
              f'{out["RQ"]:>8.1f}{out["mIoU"]:>8.1f}   '
              f'(PQ*: {out["PQ_dagger"]:.1f}  PQ_th: {out["PQ_th"]:.1f}  '
              f'PQ_st: {out["PQ_st"]:.1f})')
        print('#' * 60)
