"""Colours saved results for viewing (counterpart of ``tools/
visualization.py``): semantic, offset and instance results of one room as
a coloured point cloud, shown with open3d where it imports, else written
as an ascii ``.ply``.

    python -m softgroup_tpu_torch.tools_impl.visualization \
        --prediction_path results/ --room_name scene0011_00 \
        --task instance_pred --out scene.ply

``results/`` is what the test CLI's ``--out`` wrote (``coords/``,
``semantic_pred/``, ``semantic_label/``, ``offset_pred/``,
``pred_instance/``, ``gt_instance/``).
"""

from __future__ import annotations

import argparse
import os.path as osp

import numpy as np

TASKS = ('input', 'semantic_gt', 'semantic_pred', 'offset_semantic_pred',
         'instance_gt', 'instance_pred')

# ScanNet benchmark color map (public palette)
COLOR20 = np.array(
    [[230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
     [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
     [210, 245, 60], [250, 190, 190], [0, 128, 128], [230, 190, 255],
     [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
     [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128]])

def load(root, sub, room):
    """``<root>/<sub>/<room>.npy``."""
    return np.load(osp.join(root, sub, f'{room}.npy'))


def get_coords_color(root, room, task):
    """(xyz, colour) of ``room``'s points for ``task`` (one of
    ``TASKS``): grey input, the semantic labels or predictions in the
    palette (grey where ignored), the points shifted by the predicted
    offsets, the gt instances, or the predicted masks scoring 0.09 or more
    (grey background)."""
    xyz = load(root, 'coords', room)
    if task == 'input':
        color = np.full((len(xyz), 3), 180, np.float32)
    elif task in ('semantic_gt', 'semantic_pred'):
        sub = 'semantic_label' if task == 'semantic_gt' else 'semantic_pred'
        lbl = load(root, sub, room).astype(np.int64)
        color = np.full((len(xyz), 3), 100, np.float32)
        ok = lbl >= 0
        color[ok] = COLOR20[lbl[ok] % 20]
    elif task == 'offset_semantic_pred':
        lbl = load(root, 'semantic_pred', room).astype(np.int64)
        off = load(root, 'offset_pred', room)
        xyz = xyz + off
        color = COLOR20[np.clip(lbl, 0, 19) % 20].astype(np.float32)
    elif task == 'instance_gt':
        inst = load(root, 'gt_instance', room) if osp.exists(
            osp.join(root, 'gt_instance', f'{room}.npy')) else None
        if inst is None:
            inst = np.loadtxt(
                osp.join(root, 'gt_instance', f'{room}.txt')).astype(np.int64)
            inst = inst % 1000
        color = np.full((len(xyz), 3), 100, np.float32)
        ok = inst > 0
        color[ok] = COLOR20[inst[ok] % 20]
    else:  # instance_pred
        pred_file = osp.join(root, 'pred_instance', f'{room}.txt')
        color = np.full((len(xyz), 3), 100, np.float32)
        masks = []
        with open(pred_file) as f:
            for line in f:
                rel, label_id, conf = line.split()
                if float(conf) < 0.09:
                    continue
                m = np.loadtxt(osp.join(root, 'pred_instance', rel)) \
                    .astype(bool)
                masks.append(m)
        for i, m in enumerate(masks):
            color[m] = COLOR20[i % 20]
    return xyz, color


def write_ply(path, xyz, color):
    """An ascii ``.ply`` of float x, y, z (4 decimals) and uchar red,
    green, blue a vertex."""
    rows = np.concatenate([np.asarray(xyz, np.float64),
                           color.astype(np.uint8).astype(np.float64)], 1)
    with open(path, 'w') as f:
        f.write('ply\nformat ascii 1.0\n')
        f.write(f'element vertex {len(xyz)}\n')
        f.write('property float x\nproperty float y\nproperty float z\n')
        f.write('property uchar red\nproperty uchar green\n'
                'property uchar blue\nend_header\n')
        np.savetxt(f, rows, fmt='%.4f %.4f %.4f %d %d %d')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='colour saved results')
    p.add_argument('--prediction_path', required=True)
    p.add_argument('--room_name', required=True)
    p.add_argument('--task', default='instance_pred', choices=TASKS)
    p.add_argument('--out', default='')
    return p.parse_args(argv)


def main(argv=None) -> str | None:
    """Runs the tool on ``argv`` (None: ``sys.argv``); returns the path of
    the ``.ply`` written (None where open3d showed the cloud)."""
    args = parse_args(argv)
    xyz, color = get_coords_color(args.prediction_path, args.room_name,
                                  args.task)
    if args.out:
        assert args.out.endswith('.ply'), 'output must be .ply'
        write_ply(args.out, xyz, color)
        print(f'wrote {args.out}')
        return args.out
    try:
        import open3d as o3d
    except ImportError:
        out = f'{args.room_name}_{args.task}.ply'
        write_ply(out, xyz, color)
        print(f'open3d unavailable; wrote {out}')
        return out
    pc = o3d.geometry.PointCloud()
    pc.points = o3d.utility.Vector3dVector(xyz)
    pc.colors = o3d.utility.Vector3dVector(color / 255.0)
    o3d.visualization.draw_geometries([pc])
    return None


if __name__ == '__main__':
    main()
