"""The generator: a seed gives the same inputs every time, and a mix with a
``layout_seed`` gives every seed the same rooms' geometry, dealt in the
seed's own order with the seed's own colours and classes."""

from __future__ import annotations

import numpy as np

from portbench import generator

MIX = {'rooms': {'points': 2000, 'instances': 4, 'thing_start': 2},
       'batches': 2, 'rooms_per_batch': 2}


def _flat(pool):
    return [room for batch in pool for room in batch]


def test_a_seed_gives_the_same_rooms():
    mix = dict(MIX, layout_seed=7)
    for m in (MIX, mix):
        a = _flat(generator.train_pool(m, 2 ** 40 + 3, 20))
        b = _flat(generator.train_pool(m, 2 ** 40 + 3, 20))
        assert all(np.array_equal(x, y) for ra, rb in zip(a, b)
                   for x, y in zip(ra, rb))


def test_layout_seed_fixes_the_geometry_for_every_seed():
    mix = dict(MIX, layout_seed=7)
    a = _flat(generator.train_pool(mix, 2 ** 40 + 3, 20))
    b = _flat(generator.train_pool(mix, 11, 20))
    geometry = sorted(r[0].tobytes() + r[3].tobytes() for r in a)
    assert geometry == sorted(r[0].tobytes() + r[3].tobytes() for r in b)
    assert not all(np.array_equal(x[1], y[1]) for x, y in zip(a, b))
    for xyz, rgb, semantic, instance in a:
        assert rgb.shape == xyz.shape and rgb.dtype == np.float32
        assert semantic.dtype == np.int32
        assert (semantic[instance < 0] < 2).all()
        assert ((semantic[instance >= 0] >= 2)
                & (semantic[instance >= 0] < 20)).all()


def test_without_layout_seed_the_seed_lays_rooms_out():
    a = _flat(generator.train_pool(MIX, 5, 20))
    b = _flat(generator.train_pool(MIX, 6, 20))
    assert sorted(r[0].tobytes() for r in a) != \
        sorted(r[0].tobytes() for r in b)
