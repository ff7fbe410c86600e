"""Re-scores saved instance results (counterpart of ``tools/eval_saved.
py``): reads back what the test CLI's ``--out`` wrote and evaluates it
with ``ScanNetEval``.

    python -m softgroup_tpu_torch.tools_impl.eval_saved \
        configs/softgroup/softgroup_scannet.yaml results/ [--nproc N]

The layout (``tools_impl/test_cli.save_results``)::

    results/
      pred_instance/<scan_id>.txt          "predicted_masks/<scan>_000.txt <label> <conf>"
      pred_instance/predicted_masks/*.txt  0/1 a point
      gt_instance/<scan_id>.txt            sem * 1000 + inst + 1 a point

Where the test dataset writes NYU ids (ScanNet), the labels are mapped
back to the 1-based class ids.  The evaluator's gt size gate is the
config's ``model.test_cfg.min_npoint``, as the reference tool's.
"""

from __future__ import annotations

import argparse
import os.path as osp
from glob import glob

import numpy as np

from ..data import DATASETS
from ..evaluation.instance_eval import ScanNetEval
from ..util.config import load_config
from ..util.logger import get_root_logger
from ..util.rle import rle_encode


def load_gt(path: str, nyu_inv: dict | None) -> np.ndarray:
    """Per-point sem * 1000 + inst ids; NYU semantic ids mapped back to the
    1-based class ids where ``nyu_inv`` is given."""
    gt = np.loadtxt(path, dtype=np.int64)
    if nyu_inv is not None:
        sem = gt // 1000
        inst = gt % 1000
        mapped = np.asarray([nyu_inv.get(int(s), 0) for s in
                             np.arange(sem.max() + 1)]) \
            if len(gt) else np.zeros(1, np.int64)
        gt = np.where(sem > 0, mapped[sem] * 1000 + inst, gt)
    return gt


def load_pred(root: str, scan_id: str, nyu_inv: dict | None) -> list:
    """The scan's ``pred_instances`` (scan id, label, score, RLE mask) from
    ``<scan_id>.txt`` and its mask files; none where the file is
    missing."""
    insts = []
    index = osp.join(root, f'{scan_id}.txt')
    if not osp.isfile(index):
        return insts
    with open(index) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) != 3:
                continue
            rel, label_id, conf = parts[0], int(parts[1]), float(parts[2])
            if nyu_inv is not None:
                label_id = nyu_inv.get(label_id, 0)
            mask = np.loadtxt(osp.join(root, rel), dtype=np.int64) \
                .astype(np.uint8)
            insts.append(dict(scan_id=scan_id, label_id=label_id,
                              conf=conf, pred_mask=rle_encode(mask)))
    return insts


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='re-score saved results')
    p.add_argument('config')
    p.add_argument('result_root',
                   help='dir containing pred_instance/ and gt_instance/')
    p.add_argument('--nproc', type=int, default=None)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the tool on ``argv`` (None: ``sys.argv``), prints the
    evaluator's table and returns its result (``all_ap``, ``all_ap_50%``,
    ``all_ap_25%``, ``classes``)."""
    args = parse_args(argv)
    cfg = load_config(args.config)
    logger = get_root_logger()

    ds_cls = DATASETS[cfg.data.test.type]
    nyu_id = getattr(ds_cls, 'NYU_ID', None)
    nyu_inv = ({int(n): i + 1 for i, n in enumerate(nyu_id)}
               if nyu_id is not None else None)

    pred_root = osp.join(args.result_root, 'pred_instance')
    gt_root = osp.join(args.result_root, 'gt_instance')
    scan_ids = sorted(osp.splitext(osp.basename(f))[0]
                      for f in glob(osp.join(gt_root, '*.txt')))
    if not scan_ids:
        raise SystemExit(f'no gt txt files under {gt_root}')
    logger.info(f're-scoring {len(scan_ids)} scans from {args.result_root}')

    preds = [load_pred(pred_root, sid, nyu_inv) for sid in scan_ids]
    gts = [load_gt(osp.join(gt_root, f'{sid}.txt'), nyu_inv)
           for sid in scan_ids]

    ev = ScanNetEval(ds_cls.CLASSES,
                     min_npoint=cfg.model.test_cfg.get('min_npoint'))
    res = ev.evaluate(preds, gts, nproc=args.nproc)
    ev.print_results(res)
    return res


if __name__ == '__main__':
    main()
