"""The ScanNet benchmark's instance I/O and the ``Instance`` record
(counterpart of ``softgroup_tpu/evaluation/instance_eval_util.py``): txt
id files, ``sem * 1000 + inst`` encoded instance ids, per-instance mask
files, ``.ply`` vertex reading.

All of it is numpy: per-instance masks are vectorized, and the ``.ply``
reader needs no ``plyfile`` (the ascii and binary_little_endian vertex
layouts ScanNet ships).
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np


def transform_points(matrix: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to (N, 3) points
    (`instance_eval_util.py:10-17`)."""
    assert points.ndim == 2 and points.shape[1] == 3
    p = np.concatenate([points, np.ones((len(points), 1), points.dtype)], 1)
    p = p @ matrix.T
    return p[:, :3] / p[:, 3:4]


def export_ids(filename: str, ids: np.ndarray) -> None:
    """One integer id per line (`instance_eval_util.py:20-23`)."""
    np.savetxt(filename, np.asarray(ids).astype(np.int64), fmt='%d')


def load_ids(filename: str) -> np.ndarray:
    """Inverse of export_ids (`instance_eval_util.py:26-29`)."""
    return np.loadtxt(filename, dtype=np.int64, ndmin=1)


def read_mesh_vertices(filename: str) -> np.ndarray:
    """(N, 3) float32 vertex positions from a .ply file
    (`instance_eval_util.py:32-41`).  Self-contained reader for the ascii /
    binary_little_endian layouts of ScanNet scans (no plyfile dep)."""
    assert osp.isfile(filename), filename
    with open(filename, 'rb') as f:
        if f.readline().strip() != b'ply':
            raise ValueError(f'{filename}: not a ply file')
        fmt = None
        n_verts = 0
        props = []          # (name, numpy dtype) of the vertex element
        in_vertex = False
        _types = dict(char='i1', uchar='u1', short='i2', ushort='u2',
                      int='i4', uint='u4', float='f4', double='f8',
                      int8='i1', uint8='u1', int16='i2', uint16='u2',
                      int32='i4', uint32='u4', float32='f4', float64='f8')
        while True:
            line = f.readline().decode('ascii', 'replace').strip()
            if line == 'end_header':
                break
            parts = line.split()
            if not parts:
                continue
            if parts[0] == 'format':
                fmt = parts[1]
            elif parts[0] == 'element':
                in_vertex = parts[1] == 'vertex'
                if in_vertex:
                    n_verts = int(parts[2])
            elif parts[0] == 'property' and in_vertex:
                if parts[1] == 'list':
                    raise ValueError('list property in vertex element')
                props.append((parts[2], _types[parts[1]]))
        names = [n for n, _ in props]
        for ax in ('x', 'y', 'z'):
            if ax not in names:
                raise ValueError(f'{filename}: vertex missing {ax}')
        if fmt == 'ascii':
            data = np.loadtxt(f, dtype=np.float64, max_rows=n_verts,
                              ndmin=2)
            cols = [names.index(a) for a in 'xyz']
            return data[:, cols].astype(np.float32)
        if fmt == 'binary_little_endian':
            dt = np.dtype([(n, '<' + t) for n, t in props])
            data = np.frombuffer(f.read(dt.itemsize * n_verts), dtype=dt,
                                 count=n_verts)
            return np.stack([data[a].astype(np.float32) for a in 'xyz'], 1)
        raise ValueError(f'{filename}: unsupported ply format {fmt}')


def export_instance_ids_for_eval(filename: str, label_ids: np.ndarray,
                                 instance_ids: np.ndarray) -> None:
    """Write the benchmark submission layout: a master txt listing
    `pred_mask/<name>_<i>.txt <label> 1.0` plus one 0/1 mask file per
    instance (`instance_eval_util.py:44-67`), vectorized per instance."""
    assert label_ids.shape[0] == instance_ids.shape[0]
    name = osp.splitext(osp.basename(filename))[0]
    mask_dir = osp.join(osp.dirname(filename), 'pred_mask')
    os.makedirs(mask_dir, exist_ok=True)
    insts = np.unique(instance_ids)
    with open(filename, 'w') as f:
        for idx, inst_id in enumerate(insts):
            if inst_id == 0:      # 0 = no instance
                continue
            sel = instance_ids == inst_id
            label_id = int(label_ids[np.argmax(sel)])
            rel = osp.join('pred_mask', f'{name}_{idx}.txt')
            f.write(f'{rel} {label_id} {1.0:f}\n')
            export_ids(osp.join(osp.dirname(filename), rel),
                       sel.astype(np.int32))


class Instance:
    """Ground-truth instance record keyed by the `sem*1000+inst` encoding
    (`instance_eval_util.py:72-113`)."""

    instance_id = 0
    label_id = 0
    vert_count = 0
    med_dist = -1
    dist_conf = 0.0

    def __init__(self, mesh_vert_instances: np.ndarray, instance_id: int):
        if instance_id == -1:
            return
        self.instance_id = int(instance_id)
        self.label_id = int(instance_id // 1000)
        self.vert_count = int(
            (np.asarray(mesh_vert_instances) == instance_id).sum())

    def to_dict(self) -> dict:
        return dict(instance_id=self.instance_id, label_id=self.label_id,
                    vert_count=self.vert_count, med_dist=self.med_dist,
                    dist_conf=self.dist_conf)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=4)

    def from_json(self, data: dict) -> None:
        self.instance_id = int(data['instance_id'])
        self.label_id = int(data['label_id'])
        self.vert_count = int(data['vert_count'])
        if 'med_dist' in data:
            self.med_dist = float(data['med_dist'])
            self.dist_conf = float(data['dist_conf'])

    def __str__(self):
        return f'({self.instance_id})'


def read_instance_prediction_file(filename: str, pred_path: str) -> dict:
    """Parse a benchmark prediction txt -> {abs mask path: {label_id, conf}}
    with the reference's containment check
    (`instance_eval_util.py:115-139`)."""
    out = {}
    abs_pred = osp.abspath(pred_path)
    for line in open(filename).read().splitlines():
        parts = line.split(' ')
        if len(parts) != 3:
            raise ValueError(
                f'{filename}: expected "<rel mask path> <label> <conf>" '
                f'per line, got {line!r}')
        if osp.isabs(parts[0]):
            raise ValueError(f'{filename}: mask path must be relative')
        mask_file = osp.abspath(
            osp.join(osp.dirname(filename), parts[0]))
        if mask_file != abs_pred and not mask_file.startswith(
                abs_pred.rstrip(osp.sep) + osp.sep):
            raise ValueError(
                f'{filename}: mask {mask_file} escapes {pred_path}')
        out[mask_file] = dict(label_id=int(float(parts[1])),
                              conf=float(parts[2]))
    return out


def get_instances(ids: np.ndarray, class_ids, class_labels,
                  id2label) -> dict:
    """Group encoded gt ids into {class label: [Instance dicts]}
    (`instance_eval_util.py:142-154`)."""
    instances = {label: [] for label in class_labels}
    for inst_id in np.unique(ids):
        if inst_id == 0:
            continue
        inst = Instance(ids, inst_id)
        if inst.label_id in class_ids:
            instances[id2label[inst.label_id]].append(inst.to_dict())
    return instances
