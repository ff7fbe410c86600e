"""Surface-sampled indoor rooms: a frozen copy of
``softgroup_tpu_torch/data/synthetic.py``'s ``make_room_scene``, so that a
later change to the program cannot change the benchmark's inputs.

A room is a floor, four walls and ``n_instances`` furniture boxes sampled
on their visible faces at ScanNet's surface density, with a little noise.
Returns (xyz (N, 3) f32, rgb (N, 3) f32 in [-1, 1), semantic (N,) int32,
instance (N,) int32 with -100 for floor and walls).
"""

from __future__ import annotations

import numpy as np


def _sample_box_shell(rng, center, size, n):
    """n points on the five visible faces of an axis-aligned box, each face
    drawn in proportion to its area."""
    sx, sy, sz = size
    faces = [(2, +1, sx * sy), (0, -1, sy * sz), (0, +1, sy * sz),
             (1, -1, sx * sz), (1, +1, sx * sz)]
    areas = np.asarray([f[2] for f in faces], np.float64)
    counts = rng.multinomial(n, areas / areas.sum())
    pts = []
    for (axis, sign, _), c in zip(faces, counts):
        if c == 0:
            continue
        p = (rng.rand(c, 3).astype(np.float32) - 0.5) * size
        p[:, axis] = sign * size[axis] / 2
        pts.append(p)
    return (np.concatenate(pts) + center if pts
            else np.zeros((0, 3), np.float32))


def make_room(rng: np.random.RandomState, n_points: int, n_instances: int,
              semantic_classes: int, thing_start: int = 2,
              noise: float = 0.004):
    room = max(float(np.sqrt(n_points / 9000.0)), 2.0)
    wall_h = 2.6
    floor_area, wall_area = room * room, 4 * room * wall_h
    furn = []
    for _ in range(n_instances):
        size = np.array([rng.uniform(0.3, 1.6), rng.uniform(0.3, 1.6),
                         rng.uniform(0.3, 1.2)], np.float32)
        center = np.array([rng.uniform(size[0] / 2, room - size[0] / 2),
                           rng.uniform(size[1] / 2, room - size[1] / 2),
                           size[2] / 2], np.float32)
        area = 2 * (size[0] * size[2] + size[1] * size[2]) \
            + size[0] * size[1]
        furn.append((center, size, float(area)))
    scale = n_points / (floor_area + wall_area + sum(a for *_, a in furn))

    surf = []
    nf = max(int(floor_area * scale), 100)
    surf.append((rng.rand(nf, 3).astype(np.float32) * [room, room, 0], 0,
                 -100))
    nw = max(int(wall_area * scale), 100)
    walls = []
    for w, c in enumerate(rng.multinomial(nw, np.ones(4) / 4)):
        p = rng.rand(c, 2).astype(np.float32) * [room, wall_h]
        fixed = np.full(c, 0.0 if w in (0, 2) else room, np.float32)
        walls.append(np.stack([p[:, 0], fixed, p[:, 1]], 1) if w < 2
                     else np.stack([fixed, p[:, 0], p[:, 1]], 1))
    surf.append((np.concatenate(walls), 1, -100))
    for i, (center, size, area) in enumerate(furn):
        pts = _sample_box_shell(rng, center, size, max(int(area * scale), 50))
        cls = thing_start + int(rng.randint(semantic_classes - thing_start))
        surf.append((pts, cls, i))

    xyz = np.concatenate([p for p, _, _ in surf]).astype(np.float32)
    xyz += rng.randn(*xyz.shape).astype(np.float32) * noise
    semantic = np.concatenate(
        [np.full(len(p), c, np.int32) for p, c, _ in surf])
    instance = np.concatenate(
        [np.full(len(p), i, np.int32) for p, _, i in surf])
    rgb = rng.rand(len(xyz), 3).astype(np.float32) * 2 - 1
    return xyz, rgb, semantic, instance
