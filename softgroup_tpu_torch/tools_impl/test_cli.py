"""Inference and evaluation CLI: the counterpart of ``tools/test.py``
(every scan of a config's test split through the runner, the metrics its
``eval_tasks`` ask for, and the result writers).

    python -m softgroup_tpu_torch.tools_impl.test_cli \
        configs/softgroup/softgroup_kitti.yaml \
        --checkpoint softgroup_kitti.pth --out results/ [--max-scenes N] \
        [--device cpu]

``--checkpoint`` takes a checkpoint of the port's train CLI
(``work_dir/ckpt/epoch_N``) or a reference ``.pth`` (its weights are
imported by ``util.checkpoint.import_reference_weights``), told apart by
their keys; without one the net keeps its seeded init.  The net runs on
the card unless ``--device cpu`` is given.  ``--out`` writes what the tasks produced: semantic ``.npy``
files, instance mask ``.txt`` files, SemanticKITTI ``.label`` files.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from concurrent.futures import ProcessPoolExecutor
from functools import partial

import numpy as np

from .. import entry
from ..data import DATASETS
from ..util.checkpoint import load_weights
from ..util.config import load_config
from ..util.logger import get_root_logger
from ..util.rle import rle_decode
from .test_runner import run_split, summarize


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='softgroup_tpu_torch test')
    p.add_argument('config')
    p.add_argument('--checkpoint', default=None,
                   help='a train CLI checkpoint or a reference .pth')
    p.add_argument('--out', default=None, help='directory for result files')
    p.add_argument('--max-scenes', type=int, default=0)
    p.add_argument('--device', default='cuda',
                   help='where the net runs (cuda, or cpu for the plain '
                        'PyTorch versions of the kernels)')
    return p.parse_args(argv)


def main(argv=None, scene_stats: list | None = None,
         results_out: list | None = None) -> dict:
    """Runs the CLI on ``argv`` (None: ``sys.argv``) and returns the metric
    dict; ``scene_stats``, when given, receives each scan's ``run_scene``
    stats, and ``results_out`` each scan's results."""
    args = parse_args(argv)
    cfg = load_config(args.config)
    logger = get_root_logger()
    net = entry.build_net(cfg.model, device=args.device,
                          bf16=bool(cfg.get('tpu', {}).get('bf16', True)))
    if args.checkpoint:
        load_weights(net, args.checkpoint, logger)
    results, dataset = run_split(
        net, cfg, entry.caps_from_cfg(cfg), cfg.tpu.num_levels, logger,
        args.max_scenes, args.device, scene_stats)
    if results_out is not None:
        results_out.extend(results)
    metrics = summarize(results, cfg, dataset, logger)
    for k, v in metrics.items():
        logger.info(f'{k}: {v}')
    if args.out:
        save_results(results, args.out, cfg, dataset)
    return metrics


# ---- result writers (the reference's tools/test.py) ----

def save_npy(root, name, scan_ids, arrs):
    os.makedirs(osp.join(root, name), exist_ok=True)
    for sid, arr in zip(scan_ids, arrs):
        np.save(osp.join(root, name, f'{sid}.npy'), arr)


def save_single_instance(root, scan_id, insts, nyu_id=None):
    """``<scan_id>.txt`` (one line a mask: path, label, score) and the
    masks under ``predicted_masks/``, the ScanNet benchmark's format."""
    os.makedirs(osp.join(root, 'predicted_masks'), exist_ok=True)
    with open(osp.join(root, f'{scan_id}.txt'), 'w') as f:
        for i, inst in enumerate(insts):
            assert scan_id == inst['scan_id']
            label_id = inst['label_id']
            if nyu_id is not None:
                label_id = nyu_id[label_id - 1]
            mask_path = osp.join(root, 'predicted_masks',
                                 f'{scan_id}_{i:03d}.txt')
            f.write(f'predicted_masks/{scan_id}_{i:03d}.txt {label_id} '
                    f'{inst["conf"]:.4f}\n')
            np.savetxt(mask_path, rle_decode(inst['pred_mask']), fmt='%d')


def save_pred_instances(root, name, scan_ids, pred_insts, nyu_id=None):
    root = osp.join(root, name)
    os.makedirs(root, exist_ok=True)
    with ProcessPoolExecutor() as pool:
        list(pool.map(partial(save_single_instance, root, nyu_id=nyu_id),
                      scan_ids, pred_insts))


def save_gt_instance(path, gt_inst, nyu_id=None):
    if nyu_id is not None:
        sem = gt_inst // 1000
        ignore = sem == 0
        ins = gt_inst % 1000
        mapped = np.where(ignore, 0, np.asarray([0] + list(nyu_id))[sem])
        gt_inst = mapped * 1000 + ins
    np.savetxt(path, gt_inst, fmt='%d')


def save_gt_instances(root, name, scan_ids, gt_insts, nyu_id=None):
    root = osp.join(root, name)
    os.makedirs(root, exist_ok=True)
    paths = [osp.join(root, f'{sid}.txt') for sid in scan_ids]
    with ProcessPoolExecutor() as pool:
        list(pool.map(partial(save_gt_instance, nyu_id=nyu_id), paths,
                      gt_insts))


def save_panoptic_single(path, panoptic, learning_map_inv, num_classes):
    """A SemanticKITTI ``.label``: the raw semantic id in the low 16 bits,
    the instance id in the high 16 (uint32 a point).

    ``learning_map_inv`` is the yaml's inverse (keys 1..19: things 1..8,
    stuff 9..19); the learned classes are stuff 0..10, things 11..18
    (``data/kitti.py``), and class ``num_classes`` (what panoptic_fusion
    gives an unpasted thing) writes raw id 0 (unlabeled)."""
    cls = panoptic & 0xFFFF
    inst = panoptic >> 16
    table = np.zeros(num_classes + 1, np.uint32)
    for yaml_k, raw in learning_map_inv.items():
        if yaml_k == 0:
            continue
        ours = yaml_k + 10 if yaml_k < 9 else yaml_k - 9
        table[ours] = raw
    table[num_classes] = 0
    sem = table[np.minimum(cls, num_classes)]
    out = (inst << np.uint32(16)) | sem
    out.astype(np.uint32).tofile(path)


def save_panoptic(root, name, scan_ids, panoptics, learning_map_inv,
                  num_classes):
    """One ``.label`` a scan, at ``<root>/<name>/sequences/NN/predictions/
    <scan>.label`` (the submission layout)."""
    root = osp.join(root, name)
    for sid, pan in zip(scan_ids, panoptics):
        path = osp.join(root, sid.replace('velodyne', 'predictions') +
                        '.label')
        os.makedirs(osp.dirname(path), exist_ok=True)
        save_panoptic_single(path, pan, learning_map_inv, num_classes)


def save_results(results, out, cfg, dataset=None):
    """Writes under ``out`` what the config's ``eval_tasks`` produced."""
    scan_ids = [r['scan_id'] for r in results]
    tasks = cfg.model.test_cfg.eval_tasks
    if 'semantic' in tasks:
        save_npy(out, 'semantic_pred',
                 scan_ids, [r['semantic_preds'] for r in results])
        save_npy(out, 'semantic_label',
                 scan_ids, [r['semantic_labels'] for r in results])
        save_npy(out, 'coords', scan_ids,
                 [r['coords_float'] for r in results])
        save_npy(out, 'offset_pred', scan_ids,
                 [r['offset_preds'] for r in results])
        save_npy(out, 'offset_label', scan_ids,
                 [r['offset_labels'] for r in results])
    if 'instance' in tasks and 'pred_instances' in results[0]:
        nyu_id = DATASETS[cfg.data.test.type].NYU_ID
        save_pred_instances(out, 'pred_instance', scan_ids,
                            [r['pred_instances'] for r in results], nyu_id)
        save_gt_instances(out, 'gt_instance', scan_ids,
                          [r['gt_instances'] for r in results], nyu_id)
    if 'panoptic' in tasks and results and 'panoptic_preds' in results[0]:
        lmi = getattr(dataset, 'learning_map_inv', None)
        assert lmi is not None, \
            'the panoptic writer needs a dataset with learning_map_inv (kitti)'
        save_panoptic(out, 'panoptic', scan_ids,
                      [r['panoptic_preds'] for r in results], lmi,
                      cfg.model.semantic_classes)


if __name__ == '__main__':
    main()
