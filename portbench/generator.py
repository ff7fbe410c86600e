"""The one traffic generator: it reads a mix's parameters from
``portbench/traffic/<name>.json`` and makes the cell's inputs from the
seed.

Every seed gets the same sizes (points a room, furniture a room, rooms a
batch, batches in the pool).  Room ``j`` is drawn from ``SeedSequence([seed,
j])``, so a seed far past 32 bits is as good as a small one and the same
seed gives the same rooms.

A mix that names a ``layout_seed`` lays its rooms out from that seed alone,
so every seed gets the same rooms' geometry, and with it the same work (the
voxels and rulebook hits a layout gives vary by some percent from layout to
layout); the run's seed then deals the rooms into batches in an order of
its own and draws their colours and furniture classes anew.
"""

from __future__ import annotations

import numpy as np

from .rooms import make_room


def room_rng(seed: int, j: int) -> np.random.RandomState:
    state = np.random.SeedSequence([seed % 2 ** 64, j]).generate_state(1)
    return np.random.RandomState(int(state[0]))


def rooms(traffic: dict, seed: int, n: int, semantic_classes: int) -> list:
    """``n`` rooms of the mix (see ``rooms.make_room``)."""
    spec = traffic['rooms']
    return [make_room(room_rng(seed, j), n_points=spec['points'],
                      n_instances=spec['instances'],
                      semantic_classes=semantic_classes,
                      thing_start=spec.get('thing_start', 2))
            for j in range(n)]


def dealt_rooms(traffic: dict, seed: int, n: int,
                semantic_classes: int) -> list:
    """The ``n`` rooms laid out from the mix's ``layout_seed``, in an order
    drawn from ``seed``, each with its colours and its furniture's classes
    drawn from ``seed`` too; floor and walls keep their classes."""
    thing = traffic['rooms'].get('thing_start', 2)
    layouts = rooms(traffic, traffic['layout_seed'], n, semantic_classes)
    rng = room_rng(seed, n)     # past the indices ``rooms`` draws from
    out = []
    for j in rng.permutation(n):
        xyz, _, semantic, instance = layouts[j]
        rgb = rng.rand(len(xyz), 3).astype(np.float32) * 2 - 1
        cls = thing + rng.randint(semantic_classes - thing,
                                  size=int(instance.max()) + 1)
        semantic = np.where(instance >= 0, cls[np.maximum(instance, 0)],
                            semantic).astype(np.int32)
        out.append((xyz, rgb, semantic, instance))
    return out


def train_pool(traffic: dict, seed: int, semantic_classes: int) -> list:
    """``batches`` lists of ``rooms_per_batch`` rooms, all different (dealt
    from fixed layouts where the mix names a ``layout_seed``)."""
    b, r = traffic['batches'], traffic['rooms_per_batch']
    if 'layout_seed' in traffic:
        flat = dealt_rooms(traffic, seed, b * r, semantic_classes)
    else:
        flat = rooms(traffic, seed, b * r, semantic_classes)
    return [flat[i * r:(i + 1) * r] for i in range(b)]


def serve_pool(traffic: dict, seed: int, semantic_classes: int) -> list:
    """``pool`` rooms, served in turn by a closed loop."""
    return rooms(traffic, seed, traffic['pool'], semantic_classes)
