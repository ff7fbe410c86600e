"""The backbone's row order for K1 (``sparse_conv.hit_orders``) on the CPU.

Each rulebook level's rows are sorted stably by their 27-bit hit mask; K1
reads the grouped rulebook and writes each row back in place, so every
submanifold conv, and both of its gradients, equal the natural ones
exactly.  The plain version places the rows as the kernel does; the card's
own equality is ``tests/test_torch_cuda.py``'s.  The natural run is K1 on
the identity order (``identity_orders``).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from portbench import roofline
from softgroup_tpu_torch import entry
from softgroup_tpu_torch.data.synthetic import make_scene
from softgroup_tpu_torch.model.softgroup import Capacities, SoftGroupNet
from softgroup_tpu_torch.ops import conv_kernel as ck
from softgroup_tpu_torch.ops import sparse_conv as sc
from softgroup_tpu_torch.ops.geometry import row_ordered
from softgroup_tpu_torch.time_kernels import natural_k1, tile_taps
from softgroup_tpu_torch.util import trace

from torch_helpers import CAPS, tiny_cfg

LEVELS = 3
# K1 calls a forward on the row orders: the input conv, 8 a level (two
# blocks and two tail blocks of two convs), 4 on the last level
GROUPED_FORWARD = 1 + 8 * (LEVELS - 1) + 4


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(2, saved))
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def pyramid():
    """The pyramid of a train batch of two small rooms, its capacities
    padded past the voxels (rows that hit nothing)."""
    rng = np.random.RandomState(3)
    scenes = [make_scene(rng, n_points=1500, n_instances=4, room=3.0,
                         semantic_classes=6) for _ in range(2)]
    caps = Capacities(**dict(CAPS, voxels=(4096, 2048, 1024)))
    return entry.build_train_batch(scenes, tiny_cfg(), caps, scale=10.0,
                                   device='cpu').pyramid


def identity_orders(rulebooks):
    """``hit_orders``' stand-in for a natural run: each rulebook in its own
    row order."""
    return [(torch.arange(r.shape[1], dtype=torch.int32), r)
            for r in rulebooks]


def _masks(rules: torch.Tensor) -> torch.Tensor:
    bits = torch.tensor([1 << k for k in range(rules.shape[0])])
    return ((rules >= 0).long() * bits[:, None]).sum(0)


@pytest.mark.parametrize('level', range(LEVELS))
def test_order_is_a_stable_permutation_grouped_by_hit_mask(pyramid, level):
    rules = pyramid.levels[level].subm_rules
    rows, grouped = sc.hit_orders([rules])[0]
    v = rules.shape[1]
    assert rows.dtype == grouped.dtype == torch.int32
    assert grouped.stride(-1) == 1 and rows.is_contiguous()
    assert torch.equal(torch.sort(rows.long()).values, torch.arange(v))
    assert torch.equal(grouped, rules[:, rows.long()])
    mask = _masks(rules)[rows.long()]
    assert bool((mask[1:] >= mask[:-1]).all())
    # stable: rows of one mask keep the level's order
    same = mask[1:] == mask[:-1]
    assert bool((rows[1:][same] > rows[:-1][same]).all())
    # the rows that hit nothing (the padding) come first, together
    empty = int((_masks(rules) == 0).sum())
    assert empty >= v - int(pyramid.levels[level].vox_valid.sum()) > 0
    assert bool((mask[:empty] == 0).all()) and bool((mask[empty:] > 0).all())
    # and a tile of 64 grouped rows runs fewer taps than a natural one
    assert tile_taps(grouped)[0] < tile_taps(rules)[0]


def test_one_sort_for_all_levels_equals_each_level_alone(pyramid):
    """``hit_orders`` sorts every level's keys (the level above the mask)
    at once; each level's order is the one it has alone, the stable
    argsort of its masks."""
    rulebooks = [lv.subm_rules for lv in pyramid.levels]
    together = sc.hit_orders(rulebooks)
    for r, (rows, grouped) in zip(rulebooks, together):
        alone = sc.hit_orders([r])[0]
        assert torch.equal(rows, alone[0]) and torch.equal(grouped, alone[1])
        assert torch.equal(rows.long(),
                           torch.sort(_masks(r), stable=True).indices)
        assert torch.equal(grouped, r[:, rows.long()])
    with pytest.raises(ValueError):
        sc.hit_orders([torch.full((28, 8), -1, dtype=torch.int32)])
    with pytest.raises(ValueError):
        sc.hit_orders([rulebooks[0], rulebooks[1][:8]])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('level,cin,cout', [(0, 8, 8), (0, 6, 8), (1, 16, 24),
                                            (2, 24, 16)])
def test_grouped_call_equals_natural_exactly(pyramid, level, cin, cout,
                                             dtype):
    rules = pyramid.levels[level].subm_rules
    rows, grouped = sc.hit_orders([rules])[0]
    g = torch.Generator().manual_seed(level * 31 + cin)
    feats = torch.randn(rules.shape[1], cin, generator=g).to(dtype)
    weight = torch.randn(27, cin, cout, generator=g)
    want = ck.rulebook_conv(feats, weight, rules)
    got = ck.rulebook_conv(feats, weight, grouped, rows=rows)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    # without its rows the grouped call gives the grouped rows' outputs
    assert torch.equal(ck.rulebook_conv(feats, weight, grouped),
                       want[rows.long()])


def _recorded(monkeypatch):
    """``sparse_conv.rulebook_conv`` wrapped to keep each call's
    (args, kwargs)."""
    calls = []
    orig = sc.rulebook_conv

    def wrapped(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)
    monkeypatch.setattr(sc, 'rulebook_conv', wrapped)
    return calls


@pytest.mark.parametrize('level', range(LEVELS))
def test_subm_conv_and_its_gradients_equal_natural(pyramid, level,
                                                   monkeypatch):
    lv = row_ordered(pyramid.levels)[level]
    v = lv.subm_rules.shape[1]
    g = torch.Generator().manual_seed(level)
    x0 = torch.randn(v, 8, generator=g)
    w0 = torch.randn(27, 8, 12, generator=g)
    dy = torch.randn(v, 12, generator=g)

    def run(rows, grouped):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = sc.subm_conv(x, w, lv.subm_rules, rows, grouped)
        y.backward(dy)
        return y.detach(), x.grad, w.grad

    want = run(*identity_orders([lv.subm_rules])[0])
    calls = _recorded(monkeypatch)
    got = run(lv.subm_rows, lv.subm_grouped)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the forward and the flipped-tap dX both run on the level's order
    assert len(calls) == 2
    for args, kw in calls:
        assert args[2].data_ptr() == lv.subm_grouped.data_ptr()
        assert kw['rows'].data_ptr() == lv.subm_rows.data_ptr()
    assert torch.equal(calls[1][0][1], w0.transpose(1, 2).flip(0))


def _net() -> SoftGroupNet:
    return SoftGroupNet(channels=8, num_blocks=LEVELS, semantic_classes=6,
                        instance_classes=4, bf16=False,
                        generator=torch.Generator().manual_seed(0))


def test_row_ordered_orders_each_rulebook_level(pyramid):
    """Every rulebook level gets its order; a keyed level (no rulebook)
    stays as it is; ``apply`` carries the order."""
    keyed = replace(pyramid.levels[-1], subm_rules=None)
    levels = row_ordered((*pyramid.levels, keyed))
    for lv, base in zip(levels, pyramid.levels):
        assert lv.subm_rules is base.subm_rules
        assert torch.equal(lv.subm_grouped,
                           base.subm_rules[:, lv.subm_rows.long()])
    assert levels[-1] is keyed
    moved = levels[0].apply(lambda t: t.clone())
    assert torch.equal(moved.subm_rows, levels[0].subm_rows)
    assert moved.subm_rows is not levels[0].subm_rows


def test_counters_count_each_order_and_grouped_call(pyramid):
    """A backbone forward builds one order a level and runs every
    submanifold conv on it; its backward adds one grouped dX a conv but
    the input conv's (whose input needs no gradient)."""
    net = _net()
    x = torch.randn(pyramid.levels[0].subm_rules.shape[1], 6,
                    generator=torch.Generator().manual_seed(1))
    with trace.session() as s:
        sem, off, _ = net.backbone(x, pyramid)
    assert s.counters == {'conv.row_order': LEVELS,
                          'conv.k1_grouped': GROUPED_FORWARD}
    assert [r.name for r in s.spans].count('conv.row_order') == 1
    with trace.session() as s:
        (sem.sum() + off.sum()).backward()
    assert s.counters == {'conv.k1_grouped': GROUPED_FORWARD - 1}


def test_backbone_equals_its_natural_run(pyramid, monkeypatch):
    """The whole backbone, forward and parameter gradients, on the row
    orders and on the identity orders."""
    x = torch.randn(pyramid.levels[0].subm_rules.shape[1], 6,
                    generator=torch.Generator().manual_seed(2))

    def run():
        net = _net()
        out = net.backbone(x, pyramid)
        sum(o.float().sum() for o in out[:2]).backward()
        return out, {n: p.grad for n, p in net.named_parameters()
                     if p.grad is not None}
    got, got_g = run()
    from softgroup_tpu_torch.ops import geometry
    monkeypatch.setattr(geometry, 'hit_orders', identity_orders)
    want, want_g = run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got_g.keys() == want_g.keys() and len(got_g) > 0
    for n in got_g:
        assert torch.equal(got_g[n], want_g[n]), n


def test_tiny_unet_runs_on_row_orders(pyramid, monkeypatch):
    """The refinement head on rulebook levels (the training step's tiny
    U-Net): one order a level, built in the head, every submanifold conv
    on it, and the outputs and parameter gradients of the identity
    orders."""
    levels = pyramid.levels[:2]
    g = torch.Generator().manual_seed(5)
    x = torch.randn(levels[0].subm_rules.shape[1], 8, generator=g)
    p2v = torch.randint(0, x.shape[0], (64,), generator=g,
                        dtype=torch.int32)

    def run():
        net = _net()
        with trace.session() as s:
            out = net.instance_head(x, levels, p2v, 4)
        sum(o.sum() for o in out).backward()
        return out, {n: p.grad for n, p in net.named_parameters()
                     if p.grad is not None}, s.counters
    got, got_g, counters = run()
    # two blocks and two tail blocks of two convs on level 0, two blocks
    # on level 1
    assert counters == {'conv.row_order': 2, 'conv.k1_grouped': 12}
    from softgroup_tpu_torch.ops import geometry
    monkeypatch.setattr(geometry, 'hit_orders', identity_orders)
    want, want_g, _ = run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got_g.keys() == want_g.keys() and len(got_g) > 0
    for n in got_g:
        assert torch.equal(got_g[n], want_g[n]), n


def test_traced_wrapper_takes_every_grouped_call(pyramid, monkeypatch):
    """A subm conv forward and backward under ``rulebook_conv`` wrapped as
    ``portbench/tracing.Tracer.stretch`` wraps it: ``roofline.k1_call``
    takes each call's positional arguments, and counts the hits and bytes
    of the natural rulebook."""
    pending = []
    orig = sc.rulebook_conv

    def wrapped(*args, _orig=orig, **kw):
        pending.append(roofline.k1_call(*args))
        return _orig(*args, **kw)
    monkeypatch.setattr(sc, 'rulebook_conv', wrapped)
    lv = row_ordered(pyramid.levels)[0]
    v = lv.subm_rules.shape[1]
    x = torch.randn(v, 8, requires_grad=True)
    w = torch.randn(27, 8, 8, requires_grad=True)
    y = sc.subm_conv(x, w, lv.subm_rules, lv.subm_rows, lv.subm_grouped)
    y.sum().backward()
    assert len(pending) == 2
    natural = roofline.finish(roofline.k1_call(x, w, lv.subm_rules),
                              lambda r: int((r >= 0).sum()))
    for call in pending:
        got = roofline.finish(call, lambda r: int((r >= 0).sum()))
        assert got == natural


def test_natural_k1_places_a_recorded_grouped_call_back(pyramid):
    """``time_kernels.natural_k1``: a recorded grouped K1 call's arguments
    with the level's natural rulebook (what the kernel cases time as the
    natural K1)."""
    rules = pyramid.levels[1].subm_rules
    rows, grouped = sc.hit_orders([rules])[0]
    feats, w = torch.randn(rules.shape[1], 4), torch.randn(27, 4, 4)
    args = natural_k1(([feats, w, grouped], {'rows': rows}))
    assert args[0] is feats and args[1] is w
    assert torch.equal(args[2], rules)
    assert natural_k1(([feats, w, rules], {}))[2] is rules


def test_tile_taps_counts_hit_taps_and_density():
    rules = torch.full((27, 128), -1, dtype=torch.int32)
    rules[13] = torch.arange(128)        # every row hits itself
    rules[0, :32] = 0                    # tile 0: tap 0 on half its rows
    rules[5, 64:65] = 1                  # tile 1: tap 5 on one row
    taps, density, live = tile_taps(rules)
    assert taps == pytest.approx((2 + 2) / 2)
    assert density == pytest.approx((64 + 32 + 64 + 1) / (4 * 64))
    assert live == 2
    rules[:, 64:] = -1                   # tile 1 has no work
    assert tile_taps(rules)[2] == 1
