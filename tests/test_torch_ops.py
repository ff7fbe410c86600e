"""Parity of the PyTorch port's ops with the JAX reference on the CPU.

The same numpy inputs go through the JAX function (XLA path: Pallas
kernels are off on the CPU) and the port's function (the plain PyTorch
versions of the kernels, taken because the tensors lie on the CPU).
Tolerances: integer outputs and gathers exact; f32 products at 1e-5
(only the summation order differs).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softgroup_tpu.data.padding import build_scene_batch as jax_batch
from softgroup_tpu.model.softgroup import Capacities as JCaps
from softgroup_tpu_torch.data.padding import build_scene_batch
from softgroup_tpu_torch.model.softgroup import Capacities
from softgroup_tpu_torch.ops import conv_kernel as ck
from softgroup_tpu_torch.ops import grouping as grp
from softgroup_tpu_torch.ops import segment as seg
from softgroup_tpu_torch.ops import sparse_conv as sc
from softgroup_tpu_torch.ops import voxelize as vox
from softgroup_tpu_torch.ops.gather_kernel import row_gather, row_gather_plain
from softgroup_tpu_torch.ops.join_kernel import (cell_neighbor_join,
                                                 cell_neighbor_join_plain)

from torch_helpers import CAPS, batch_args, tiny_data

torch.set_num_threads(1)
# the reference's modules by path (softgroup_tpu.ops re-exports functions
# under some module names)
jck, jgrp, jseg, jsc, jvox = (
    importlib.import_module(f'softgroup_tpu.ops.{m}') for m in (
        'conv_kernel', 'grouping', 'segment', 'sparse_conv', 'voxelize'))
INT_MAX = 2 ** 31 - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope='module')
def batches():
    data = tiny_data()
    tb = build_scene_batch(*batch_args(data), Capacities(**CAPS),
                           num_levels=3, device='cpu')
    jb = jax_batch(*batch_args(data), JCaps(**CAPS), num_levels=3)
    return tb, jb


class TestSparseConv:

    @pytest.mark.parametrize('level', [0, 1, 2])
    @pytest.mark.parametrize('cin,cout', [(6, 8), (16, 8)])
    def test_subm_conv(self, batches, level, cin, cout):
        tb, jb = batches
        rng = np.random.RandomState(level * 7 + cin)
        rules = tb.pyramid.levels[level].subm_rules
        v = rules.shape[1]
        x = rng.randn(v, cin).astype(np.float32)
        w = (rng.randn(27, cin, cout) * 0.2).astype(np.float32)
        ref = jsc.subm_conv(jnp.asarray(x), jnp.asarray(w),
                            jb.pyramid.levels[level].subm_rules)
        out = sc.subm_conv(_t(x), _t(w), rules, *sc.hit_orders([rules])[0])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize('level', [0, 1])
    def test_down_and_inverse_conv(self, batches, level):
        tb, jb = batches
        rng = np.random.RandomState(level)
        lv, jlv = tb.pyramid.levels[level], jb.pyramid.levels[level]
        vf = lv.vox_valid.shape[0]
        vc = lv.down_rules.shape[1]
        x = rng.randn(vf, 8).astype(np.float32)
        w = (rng.randn(8, 8, 16) * 0.2).astype(np.float32)
        ref = jsc.down_conv(jnp.asarray(x), jnp.asarray(w), jlv.down_rules)
        out = sc.down_conv(_t(x), _t(w), lv.down_rules)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
        y = rng.randn(vc, 16).astype(np.float32)
        wu = (rng.randn(8, 16, 8) * 0.2).astype(np.float32)
        ref = jsc.inverse_conv(jnp.asarray(y), jnp.asarray(wu),
                               jlv.parent_idx, jlv.child_tap)
        out = sc.inverse_conv(_t(y), _t(wu), lv.parent_idx, lv.child_tap)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)

    def test_linear(self):
        rng = np.random.RandomState(3)
        x = rng.randn(100, 12).astype(np.float32)
        w = rng.randn(12, 5).astype(np.float32)
        b = rng.randn(5).astype(np.float32)
        ref = jsc.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        np.testing.assert_allclose(sc.linear(_t(x), _t(w), _t(b)).numpy(),
                                   np.asarray(ref), rtol=1e-5, atol=1e-5)


class TestGather:

    def test_devoxelize(self, batches):
        tb, jb = batches
        rng = np.random.RandomState(5)
        v0 = tb.pyramid.levels[0].vox_valid.shape[0]
        x = rng.randn(v0, 8).astype(np.float32)
        ref = jvox.devoxelize(jnp.asarray(x), jb.pyramid.p2v)
        np.testing.assert_array_equal(
            vox.devoxelize(_t(x), tb.pyramid.p2v).numpy(), np.asarray(ref))

    @pytest.mark.parametrize('dtype', [np.float32, np.int32])
    def test_row_gather_plain(self, dtype):
        rng = np.random.RandomState(6)
        src = (rng.randn(300, 4) * 100).astype(dtype)
        idx = rng.randint(-5, 310, size=1000).astype(np.int32)
        want = src[np.clip(idx, 0, 299)]
        np.testing.assert_array_equal(row_gather_plain(_t(src), _t(idx)),
                                      want)
        np.testing.assert_array_equal(row_gather(_t(src), _t(idx)), want)


def _keyed_tables(rng, d, n_prop, v_cap):
    """Sorted fine (2d grid) and coarse (d grid) key tables, INT_MAX
    padded, of random voxels in n_prop proposals."""
    df = 2 * d
    b = rng.randint(0, n_prop, 900)
    xyz = rng.randint(0, df, (900, 3))
    fine = np.unique(((b * df + xyz[:, 0]) * df + xyz[:, 1]) * df
                     + xyz[:, 2])
    fb, fz = fine // df ** 3, fine % df
    fy, fx = (fine // df) % df, (fine // df ** 2) % df
    coarse = np.unique(((fb * d + fx // 2) * d + fy // 2) * d + fz // 2)

    def pad(k, cap):
        out = np.full(cap, INT_MAX, np.int32)
        out[:len(k)] = k
        return out
    return pad(fine, v_cap), pad(coarse, v_cap)


class TestKeyedConv:

    @pytest.mark.parametrize('strided', [False, True])
    def test_keyed_conv_plain(self, strided):
        rng = np.random.RandomState(11)
        d = 5
        fine, coarse = _keyed_tables(rng, d, 6, 1024)
        if strided:
            out_k, in_k, dd, k = coarse, fine, d, 8
            offs = jck._DOWN_OFFS
        else:
            out_k, in_k, dd, k = fine, fine, 2 * d, 27
            offs = jck._SUBM_OFFS
        x = rng.randn(len(in_k), 8).astype(np.float32)
        w = (rng.randn(k, 8, 16) * 0.2).astype(np.float32)
        jrules = jck._rules_from_keys(jnp.asarray(out_k), jnp.asarray(in_k),
                                      dd, offs, strided)
        rules = ck.rules_from_keys(_t(out_k), _t(in_k), dd, strided)
        np.testing.assert_array_equal(rules.numpy(), np.asarray(jrules))
        assert (rules >= 0).sum() > len(out_k) // 4
        ref = jsc._conv_xla(jnp.asarray(x), jnp.asarray(w), jrules,
                            jnp.float32)
        out = ck.keyed_conv(_t(x), _t(w), _t(out_k), _t(in_k), dd, strided)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


class TestVoxelizeSegment:

    def test_voxelize_linear(self):
        rng = np.random.RandomState(12)
        c = np.concatenate([rng.randint(0, 7, (3000, 1)),
                            rng.randint(0, 10, (3000, 3))], 1).astype(np.int32)
        valid = rng.rand(3000) < 0.9
        for cap in (1024, 4096):   # truncating and padded
            jv, jk = jvox.voxelize_linear(jnp.asarray(c), jnp.asarray(valid),
                                          jnp.asarray([10, 10, 10]), cap)
            tv, tk = vox.voxelize_linear(_t(c), _t(valid), (10, 10, 10), cap)
            np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
            for a, b in zip(tv, jv):
                np.testing.assert_array_equal(np.asarray(a.numpy()),
                                              np.asarray(b))

    def test_segment_reductions(self):
        rng = np.random.RandomState(13)
        x = rng.randn(1024, 3).astype(np.float32)
        ids = np.sort(rng.randint(0, 40, 1024)).astype(np.int32)
        ids[-50:] = 32                      # dustbin tail, segments 0..31
        mn, mx = jseg.sorted_segment_minmax(jnp.asarray(x), jnp.asarray(ids),
                                            32)
        np.testing.assert_array_equal(seg.segment_min(_t(x), _t(ids), 32),
                                      np.asarray(mn))
        np.testing.assert_array_equal(seg.segment_max(_t(x), _t(ids), 32),
                                      np.asarray(mx))
        np.testing.assert_allclose(
            seg.segment_mean_fused(_t(x), _t(ids), 32).numpy(),
            np.asarray(jseg.segment_mean_fused(jnp.asarray(x),
                                               jnp.asarray(ids), 32)),
            rtol=1e-5, atol=1e-6)


class TestGrouping:

    def test_cell_join_plain_matches_reference(self):
        """The K3 plain version against the reference's XLA join + gate."""
        from softgroup_tpu.ops.join_kernel import xla_cell_join
        rng = np.random.RandomState(14)
        m = 512
        cc = rng.randint(0, 12, (700, 3))
        key = np.unique((cc[:, 0] * 12 + cc[:, 1]) * 12 + cc[:, 2])[:m - 40]
        keys = np.full(m, INT_MAX, np.int32)
        keys[:len(key)] = key
        coord = np.zeros((m, 3), np.int32)
        coord[:len(key)] = np.stack([key // 144, (key // 12) % 12, key % 12],
                                    1)
        cen = ((coord + rng.rand(m, 3)) / 64).astype(np.float32)
        dims = np.array([12, 12, 12], np.int32)
        offs = grp.offsets(1)
        ref = xla_cell_join(jnp.asarray(keys), jnp.asarray(cen),
                            jnp.asarray(coord), jnp.asarray(dims), offs,
                            jnp.float32(0.02))
        out = cell_neighbor_join(_t(keys), _t(cen), _t(coord), _t(dims),
                                 offs, 0.02)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(
            cell_neighbor_join_plain(_t(keys), _t(cen), _t(coord), _t(dims),
                                     offs, 0.02).numpy(), np.asarray(ref))
        assert (out >= 0).sum() > 100

    def test_cell_join_plain_matches_pallas_kernel(self):
        """The K3 plain version against the reference's Pallas kernel
        itself (interpret mode, forced past its overflow test) on a
        multi-group layout: four groups folded into x, centroids on a 1/64
        grid (exact in f32 and in the kernel's bf16x3 split, so the gate
        sees the same distances), ties at the radius included."""
        from softgroup_tpu.ops.join_kernel import \
            cell_neighbor_join as pallas_join
        rng = np.random.RandomState(16)
        m, d = 1024, np.array([10, 12, 9])
        cells = np.stack([rng.randint(0, 4, 2000), rng.randint(0, 8, 2000),
                          rng.randint(0, 10, 2000), rng.randint(0, 7, 2000)],
                         1)
        key = np.unique(((cells[:, 0] * d[0] + cells[:, 1]) * d[1]
                         + cells[:, 2]) * d[2] + cells[:, 3])[:m - 70]
        keys = np.full(m, INT_MAX, np.int32)
        keys[:len(key)] = key
        coord = np.zeros((m, 3), np.int32)
        coord[:len(key)] = np.stack([(key // (d[1] * d[2])) % d[0],
                                     (key // d[2]) % d[1], key % d[2]], 1)
        cen = ((coord + rng.randint(0, 16, (m, 3)) / 16) / 4).astype(
            np.float32)
        offs = grp.offsets(1)
        ref = pallas_join(jnp.asarray(keys), jnp.asarray(cen),
                          jnp.asarray(coord), jnp.asarray(d.astype(np.int32)),
                          tuple(map(tuple, offs.tolist())), 0.25,
                          block_b=128, window_w=512, interpret=True,
                          force_kernel=True)
        out = cell_neighbor_join_plain(_t(keys), _t(cen), _t(coord),
                                       _t(d.astype(np.int32)), offs, 0.25)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        hits = cell_neighbor_join_plain(_t(keys), _t(cen), _t(coord),
                                        _t(d.astype(np.int32)), offs,
                                        float('inf'))
        assert 1000 < int((out >= 0).sum()) < int((hits >= 0).sum())

    @pytest.mark.parametrize('m_cap', [512, 4096])
    def test_cell_cluster_csr(self, m_cap):
        """Same sorted labels and payload; m_cap=512 truncates cells."""
        rng = np.random.RandomState(15)
        n = 4096
        centers = rng.rand(12, 3) * 3
        pts = centers[rng.randint(0, 12, n)] + rng.randn(n, 3) * 0.08
        pts = (np.round(pts * 64) / 64).astype(np.float32)
        group = rng.randint(0, 8, n).astype(np.int32)
        valid = rng.rand(n) < 0.95
        payload = rng.permutation(n).astype(np.int32)
        thr = np.full(4, 5.0, np.float32)
        jl, jp = jgrp.cell_cluster_csr(
            jnp.asarray(pts), jnp.asarray(group), jnp.asarray(valid),
            jnp.asarray(payload), jnp.asarray(thr), jnp.float32(0.1),
            cell_scale=1.0, m_cap=m_cap, pair_keys=False)
        tl, tp = grp.cell_cluster_csr(
            _t(pts), _t(group), _t(valid), _t(payload), _t(thr), 0.1,
            cell_scale=1.0, m_cap=m_cap, pair_keys=False)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert len(np.unique(tl.numpy()[tl.numpy() >= 0])) > 5


# The (K, V_out, Cin, Cout) of the 79 K5 calls of one all-params train step
# of the flagship config (entry.train_cfg / train_capacities): every shape
# once, and two edge shapes (one row; more 32-row steps than 65535).
DW_STEP_SHAPES = [
    (27, 131072, 32, 32), (27, 131072, 64, 32), (8, 32768, 32, 64),
    (27, 32768, 64, 64), (27, 851968, 32, 32), (27, 851968, 64, 32),
    (8, 425984, 32, 64), (27, 425984, 64, 64), (27, 425984, 128, 64),
    (8, 131072, 64, 96), (27, 131072, 96, 96), (27, 131072, 192, 96),
    (8, 65536, 96, 128), (27, 65536, 128, 128), (27, 65536, 256, 128),
    (8, 16384, 128, 160), (27, 16384, 160, 160), (27, 16384, 320, 160),
    (8, 8192, 160, 192), (27, 8192, 192, 192), (27, 8192, 384, 192),
    (8, 4096, 192, 224), (27, 4096, 224, 224), (27, 851968, 6, 32),
    (27, 1, 32, 32), (1, 32 * 70000 + 5, 32, 32)]


@pytest.mark.parametrize('bf16', [True, False], ids=['bf16', 'f32'])
@pytest.mark.parametrize('shape', DW_STEP_SHAPES,
                         ids=[str(s) for s in DW_STEP_SHAPES])
def test_dw_plan_covers_each_tap_and_step_once(shape, bf16):
    """K5's grid plan (csrc/conv.cu sg_conv_dw): blocks (tap group y, z) of
    a tile, block z taking steps z, z + split, ..., cover every (tap, step)
    exactly once, every block has a step, grid.y and grid.z stay within
    65535, and the grid is cut only as far as the fill asks."""
    k, v_out, cin, cout = shape
    group, split = ck._dw_plan(k, v_out, cin, cout, bf16)
    rows = ck._DW_STEP_ROWS if bf16 else ck._DW_FMA_ROWS
    n_steps = -(-v_out // rows)
    groups = -(-k // group)
    assert group == (ck._DW_GROUP if bf16 and n_steps > ck._DW_FEW_STEPS
                     else 1)
    assert 1 <= split <= min(n_steps, 65535) and groups <= 65535
    seen = np.zeros((k, n_steps), np.int64)
    for y in range(groups):
        for z in range(split):
            steps = np.arange(z, n_steps, split)
            assert len(steps) > 0
            seen[y * group:min(k, (y + 1) * group), steps] += 1
    assert (seen == 1).all()
    ti, tj = (32 if cin <= 32 else 64), (32 if cout <= 32 else 64)
    base = groups * -(-cin // ti) * -(-cout // tj)
    fill = (ck._DW_FMA_FILL_BLOCKS if not bf16 else ck._DW_WIDE_FILL_BLOCKS
            if group > 1 and ti == tj == 64 else ck._DW_FILL_BLOCKS)
    if split > 1:   # cut only as far as the grid needs
        assert (split - 1) * base < fill


@pytest.mark.parametrize('strided,d,v_out,cin,cout', [
    (False, 20, 65536, 32, 32), (True, 10, 16384, 32, 64),
    (False, 20, 256, 6, 32), (False, 20, 256, 64, 32),
    (True, 10, 128, 96, 64)])
def test_keyed_conv_split_is_k1_step_list(strided, d, v_out, cin, cout):
    """K4 runs K1's kernel, so its bf16 split is K1's step-list rule (a
    tile's steps of 32 channels of (hit tap, chunk) pieces), for a grid of
    about _K4_FILL_BLOCKS; it may exceed the tap count.  f32 keeps the
    tap-range rule of the FMA kernel."""
    k = 8 if strided else 27
    pw = 16 if cin <= 16 else 32
    steps = -(-k * -(-cin // pw) // (32 // pw))
    tiles = -(-v_out // 64) * -(-cout // (32 if cout <= 32 else 64))
    fill = ck._K4_FILL_BLOCKS
    want = 1 if tiles >= fill else min(steps, -(-fill // tiles))
    assert ck._conv_split(k, cin, v_out, cout, torch.bfloat16, fill) == want
    f32 = ck._conv_split(k, cin, v_out, cout, torch.float32)
    assert 1 <= f32 <= k
    if tiles < 8:   # few tiles: every step its own block
        assert want == steps
        if cin > 32:
            assert want > k >= f32
    # the flagship request's two K4 convs fill the card without a split
    if v_out in (65536, 16384):
        assert want == 1


@pytest.mark.parametrize('row_bytes,rows', [
    (38, 512), (64, 512), (128, 320), (140, 288), (1024, 32), (3000, 32)])
def test_segment_sum_chunk_rows(row_bytes, rows):
    """K6's rows per chunk: at most ``_SEG_ROWS``, a multiple of 32 (at
    least 32) that keeps a chunk within 40 KB of shared memory; the three
    widths of the train step (19 bf16, 32 bf16, 35 f32) get 512, 512 and
    288 rows."""
    from softgroup_tpu_torch.ops import gather_kernel as gk
    assert gk.seg_rows_per_chunk(row_bytes) == rows
    assert rows % 32 == 0 and (rows == 32 or rows * row_bytes <= 40960)


@pytest.mark.parametrize('m,tile', [(131072, 64), (32768, 32), (65536, 32),
                                    (1 << 20, 256), (1, 32)])
def test_rules_join_tile(m, tile):
    """K7's tile: the largest of 256, 128, 64, 32 rows that leaves 2048
    blocks, 32 at least (64 at the tiny U-Net's level 0, 32 at level 1)."""
    from softgroup_tpu_torch.ops import join_kernel as jk
    assert jk._k7_tile(m) == tile
    assert tile == 32 or m // tile >= jk._K7_MIN_BLOCKS


def test_cell_join_plan():
    """K3's launch plan: the grouping's neighbour offsets are one read-only
    array per reach in ascending (dx, dy, dz) order, and the plan built
    once per offset set holds them with their runs (one (dx, dy), rising
    dz): 9 runs of the 26 offsets, 25 of the 124 at reach 2, a run cut
    where dz falls; more than 128 offsets are refused."""
    from softgroup_tpu_torch.ops import join_kernel as jk
    a = grp.offsets(1)
    assert a is grp.offsets(1) and not a.flags.writeable
    assert a.shape == (26, 3) and grp.offsets(2).shape == (124, 3)
    assert [tuple(o) for o in a] == sorted(tuple(o) for o in a)
    plan = jk._k3_plan(a)
    assert jk._k3_plan(a.copy()) is plan and plan.dtype == np.int32
    runs = 2 + 3 * jk._K3_MAX_OFFSETS
    assert list(plan[:2]) == [26, 9]
    np.testing.assert_array_equal(plan[2:2 + 78], a.reshape(-1))
    assert list(plan[runs:runs + 10]) == [0, 3, 6, 9, 12, 14, 17, 20, 23, 26]
    assert list(jk._k3_plan(grp.offsets(2))[:2]) == [124, 25]
    flipped = np.array([[0, 0, 1], [0, 0, -1], [0, 1, -1], [1, 1, 0]])
    plan = jk._k3_plan(flipped)
    assert list(plan[:2]) == [4, 4] and list(plan[runs:runs + 5]) == [
        0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        jk._k3_plan(np.zeros((129, 3), np.int32))


def test_trace_short():
    """A profile of reps calls is whole when each kernel appears reps x its
    launches in one call: a kernel seen fewer times, not at all, or though
    one call has none, is named."""
    from softgroup_tpu_torch.time_kernels import trace_short
    one = {'cell_join': 1, 'segment_sum_chunks': 1, 'Memset': 2}
    rows = [(0.2, 20, 'cell_join'), (0.4, 20, 'segment_sum_chunks'),
            (0.01, 40, 'Memset')]
    assert trace_short(rows, 20, one) == []
    assert trace_short(rows[:2] + [(0.01, 38, 'Memset')], 20, one) == [
        'Memset']
    assert trace_short(rows[1:], 20, one) == ['cell_join']
    assert trace_short(rows + [(0.1, 20, 'sum_partials')], 20, one) == [
        'sum_partials']
    assert trace_short([], 20, one) == sorted(one)
