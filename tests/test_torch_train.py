"""Parity of the PyTorch port's training step with the JAX reference on the
CPU: the training ops (K5, K6 and K7's plain versions, the conv, gather and
devoxelize backwards, the training rulebooks, the masked batch norm, the
masks and the instance loss), then the whole slice: one
``jax.jit(jax.value_and_grad(loss_forward))`` of the tiny config against
the port's ``loss_forward`` -> ``backward`` -> Adam step.

The JAX side runs as its own tests run it on the CPU (Pallas kernels off,
the XLA route), with ``bf16=False`` and f32 matmul precision; the port runs
on CPU tensors, so every kernel takes its plain version.  Inputs come from
a seed with numpy; the tiny batch has coordinates on a 1/64 grid and the
offset head is zeroed, so grouping is exact.

Tolerances: integer outputs and rulebooks exact; f32 results of the same
math in another summation order at 1e-5 for single ops and at 1e-4 (x
max(1, max|ref|) for gradients) for the whole step, whose values pass
through tens of layers.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from softgroup_tpu.data.padding import build_scene_batch as jax_batch
from softgroup_tpu.model.blocks import MaskedBatchNorm as JBN
from softgroup_tpu.model.softgroup import Capacities as JCaps
from softgroup_tpu.model.softgroup import Proposals as JProposals
from softgroup_tpu.model.softgroup import SoftGroupNet as JNet
from softgroup_tpu_torch import entry
from softgroup_tpu_torch.data.padding import build_scene_batch
from softgroup_tpu_torch.model.blocks import MaskedBatchNorm
from softgroup_tpu_torch.model.softgroup import (Capacities, Proposals,
                                                 SoftGroupNet, instance_loss)
from softgroup_tpu_torch.ops import conv_kernel as ck
from softgroup_tpu_torch.ops import gather_kernel as gk
from softgroup_tpu_torch.ops import join_kernel as jk
from softgroup_tpu_torch.ops import masks as msk
from softgroup_tpu_torch.ops import rulebook as rb
from softgroup_tpu_torch.ops import sparse_conv as sc
from softgroup_tpu_torch.ops import voxelize as vox
from softgroup_tpu_torch.train import BACKBONE_NORM_MODULES
from softgroup_tpu_torch.util import optim
from softgroup_tpu_torch.util.config import Config
from softgroup_tpu_torch.util.convert import from_jax_variables

from torch_helpers import CAPS, batch_args, tiny_cfg, tiny_data

torch.set_num_threads(1)
jgk, jjk, jmsk, jopt, jrb, jsc, jsg, jvox = (
    importlib.import_module(f'softgroup_tpu.{m}') for m in (
        'ops.gather_kernel', 'ops.join_kernel', 'ops.masks', 'util.optim',
        'ops.rulebook', 'ops.sparse_conv', 'model.softgroup',
        'ops.voxelize'))
INT_MAX = 2 ** 31 - 1
FROZEN = ('input_conv', 'unet', 'output_norm', 'semantic_linear',
          'offset_linear')
LOG_KEYS = ('semantic_loss', 'offset_loss', 'cls_loss', 'mask_loss',
            'iou_score_loss', 'num_pos', 'num_neg', 'loss')


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol, what=''):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


def _close_scaled(a, b, tol, what=''):
    """|a - b| <= tol * max(1, max|b|): sums of many products, where one
    rounding is relative to the largest partial sum, not to each entry."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err = float(np.abs(a - b).max()) if b.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(b).max())), (what, err)


@pytest.fixture(scope='module')
def batches():
    data = tiny_data()
    tb = build_scene_batch(*batch_args(data), Capacities(**CAPS),
                           num_levels=3, device='cpu')
    jb = jax_batch(*batch_args(data), JCaps(**CAPS), num_levels=3)
    return tb, jb


# ---------------------------------------------------------------------------
# (a) K5 plain vs the reference's weight vjp; (b) the conv backwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('level,kind', [(0, 'subm'), (1, 'subm'),
                                        (0, 'down')])
def test_conv_dw_plain(batches, level, kind):
    tb, jb = batches
    rules = getattr(tb.pyramid.levels[level], f'{kind}_rules')
    jrules = getattr(jb.pyramid.levels[level], f'{kind}_rules')
    rng = np.random.RandomState(level + 10 * (kind == 'down'))
    v_in = tb.pyramid.levels[level].vox_valid.shape[0]
    x = rng.randn(v_in, 6).astype(np.float32)
    g = rng.randn(rules.shape[1], 12).astype(np.float32)
    w0 = jnp.zeros((rules.shape[0], 6, 12), jnp.float32)
    ref = jax.vjp(lambda w: jsc._conv_xla(jnp.asarray(x), w, jrules,
                                          jnp.float32), w0)[1](
        jnp.asarray(g))[0]
    out = ck.rulebook_conv_dw(_t(x), _t(g), rules)
    assert out.dtype == torch.float32
    _close_scaled(out, ref, 1e-5)
    assert float(np.abs(np.asarray(ref)).max()) > 1.0


def _torch_vjp(fn, x, w, g):
    xt = _t(x).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    fn(xt, wt).backward(_t(g))
    return xt.grad, wt.grad


@pytest.mark.parametrize('kind', ['subm', 'down', 'inverse'])
def test_conv_backward(batches, kind):
    """g_feats and g_weight of the three autograd Functions against
    jax.vjp of subm_conv, down_conv and inverse_conv(..., down_rules)."""
    tb, jb = batches
    lv, jlv = tb.pyramid.levels[0], jb.pyramid.levels[0]
    vf, vc = lv.vox_valid.shape[0], lv.down_rules.shape[1]
    rng = np.random.RandomState(20)
    if kind == 'subm':
        k, v_in, v_out = 27, vf, vf
        order = sc.hit_orders([lv.subm_rules])[0]
        port = lambda x, w: sc.subm_conv(x, w, lv.subm_rules, *order)
        ref = lambda x, w: jsc.subm_conv(x, w, jlv.subm_rules)
    elif kind == 'down':
        k, v_in, v_out = 8, vf, vc
        port = lambda x, w: sc.down_conv(x, w, lv.down_rules)
        ref = lambda x, w: jsc.down_conv(x, w, jlv.down_rules)
    else:
        k, v_in, v_out = 8, vc, vf
        port = lambda x, w: sc.inverse_conv(x, w, lv.parent_idx,
                                            lv.child_tap, lv.down_rules)
        ref = lambda x, w: jsc.inverse_conv(x, w, jlv.parent_idx,
                                            jlv.child_tap, jlv.down_rules)
    x = rng.randn(v_in, 8).astype(np.float32)
    w = (rng.randn(k, 8, 16) * 0.2).astype(np.float32)
    g = rng.randn(v_out, 16).astype(np.float32)
    gx, gw = _torch_vjp(port, x, w, g)
    rx, rw = jax.vjp(ref, jnp.asarray(x), jnp.asarray(w))[1](jnp.asarray(g))
    _close_scaled(gx, rx, 1e-5, 'g_feats')
    _close_scaled(gw, rw, 1e-5, 'g_weight')
    assert float(np.abs(np.asarray(rx)).max()) > 0.5


# ---------------------------------------------------------------------------
# (c) K6 plain and the gather backwards
# ---------------------------------------------------------------------------

def test_segment_sum_plain():
    rng = np.random.RandomState(30)
    vals = rng.randn(3000, 5).astype(np.float32)
    seg = np.sort(rng.randint(-3, 260, 3000)).astype(np.int32)
    ref = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg),
                              num_segments=256)
    out = gk.sorted_segment_sum(_t(vals), _t(seg), 256)
    assert out.dtype == torch.float32 and out.shape == (256, 5)
    _close(out, ref, 1e-5)
    assert (seg >= 256).sum() > 10 and (seg < 0).sum() > 0


def _segsum_windows_fit(seg, num_segments, b=256, w=1024):
    """True when every block of the JAX kernel finds its rows in its window
    (``monotone_segment_sum`` takes its Pallas branch, not the fallback)."""
    n = len(seg)
    bounds = np.searchsorted(seg, np.arange(0, num_segments + b, b))
    starts = np.clip(bounds[:-1], 0, max(n - w, 0)) // 128 * 128
    return bool((bounds[1:] <= starts + w).all())


@pytest.mark.parametrize('dtype,c', [('bfloat16', 19), ('float32', 35)])
def test_segment_sum_vs_pallas(dtype, c):
    """K6's plain version against the reference's Pallas kernel
    (``monotone_segment_sum``, bf16; ``monotone_segment_sum_f32``, the
    exact bf16x3 split, f32) in interpret mode, at a shape it takes (N %
    128 == 0, S % 256 == 0, N >= 1024): out-of-range rows at both ends, a
    400-row run, empty segments; the output in the values' dtype is the
    f32 sum rounded once, and f32 values take no bf16 output."""
    rng = np.random.RandomState(33)
    n, s = 2048, 1024
    seg = np.sort(np.concatenate([
        rng.randint(-5, 0, 30), np.full(400, 300),
        rng.choice(np.r_[0:300, 301:s], 1568), rng.randint(s, s + 20, 50)]))
    seg = seg.astype(np.int32)
    assert _segsum_windows_fit(seg, s)
    vals = rng.randn(n, c).astype(np.float32)
    if dtype == 'bfloat16':
        jv = jnp.asarray(vals).astype(jnp.bfloat16)
        ref = jgk.monotone_segment_sum(jv, jnp.asarray(seg), s,
                                       interpret=True)
        tv = _t(np.asarray(jv.astype(jnp.float32))).bfloat16()
    else:
        ref = jgk.monotone_segment_sum_f32(jnp.asarray(vals),
                                           jnp.asarray(seg), s,
                                           interpret=True)
        tv = _t(vals)
    ref = np.asarray(ref)
    out = gk.sorted_segment_sum(tv, _t(seg), s)
    assert out.dtype == torch.float32 and out.shape == (s, c)
    _close_scaled(out, ref, 1e-5)
    assert (ref == 0).all(axis=1).sum() > 100   # empty segments
    same = gk.sorted_segment_sum(tv, _t(seg), s, out_dtype=tv.dtype)
    assert same.dtype == tv.dtype
    assert torch.equal(same, out.to(tv.dtype))
    np.testing.assert_allclose(same.float().numpy(), ref,
                               rtol=2.0 ** -8, atol=1e-5)
    if tv.dtype == torch.float32:   # out is f32 or the values' dtype
        with pytest.raises(ValueError):
            gk.sorted_segment_sum(tv, _t(seg), s, out_dtype=torch.bfloat16)


def test_devoxelize_backward(batches):
    tb, jb = batches
    rng = np.random.RandomState(31)
    v0 = tb.pyramid.levels[0].vox_valid.shape[0]
    x = rng.randn(v0, 8).astype(np.float32)
    g = rng.randn(tb.pyramid.p2v.shape[0], 8).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    vox.devoxelize(xt, tb.pyramid.p2v).backward(_t(g))
    ref = jax.vjp(lambda a: jvox.devoxelize(a, jb.pyramid.p2v),
                  jnp.asarray(x))[1](jnp.asarray(g))[0]
    _close(xt.grad, ref, 1e-5)
    # the pad points (p2v = capacity) add their cotangent to the last row
    assert int((tb.pyramid.p2v >= v0).sum()) > 0


def test_unsorted_gather_backward():
    rng = np.random.RandomState(32)
    src = rng.randn(500, 7).astype(np.float32)
    idx = rng.randint(0, 500, 4000).astype(np.int32)
    g = rng.randn(4000, 7).astype(np.float32)
    st = _t(src).requires_grad_(True)
    out = gk.gather_rows(st, _t(idx))
    np.testing.assert_array_equal(out.detach().numpy(), src[idx])
    out.backward(_t(g))
    ref = jax.vjp(lambda a: jgk.gather_rows_segsum_vjp(a, jnp.asarray(idx)),
                  jnp.asarray(src))[1](jnp.asarray(g))[0]
    _close(st.grad, ref, 1e-5)


@pytest.mark.parametrize('sorted_idx', [False, True])
def test_gather_backward_bf16_vs_pallas(sorted_idx):
    """``gather_rows``' backward on bf16 rows (K6 writing the gradient in
    bf16, one rounding of the f32 sum) against ``jax.vjp`` of the
    reference's gather with its Pallas backward (argsort, gather, the
    segment-sum kernel) in interpret mode."""
    from softgroup_tpu.ops import dispatch
    rng = np.random.RandomState(34)
    src = rng.randn(512, 19).astype(np.float32)
    idx = rng.randint(0, 512, 2048).astype(np.int32)
    if sorted_idx:
        idx = np.sort(idx)
    g = rng.randn(2048, 19).astype(np.float32)
    js, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (src, g))
    dispatch.set_kernels(True)
    dispatch.set_interpret(True)
    try:
        ref = jax.vjp(lambda a: jgk.gather_rows_segsum_vjp(
            a, jnp.asarray(idx)), js)[1](jg)[0]
    finally:
        dispatch.set_kernels(None)
        dispatch.set_interpret(None)
    assert ref.dtype == jnp.bfloat16
    st = _t(np.asarray(js.astype(jnp.float32))).bfloat16().requires_grad_(
        True)
    out = gk.gather_rows(st, _t(idx), sorted_idx=sorted_idx)
    out.backward(_t(np.asarray(jg.astype(jnp.float32))).bfloat16())
    assert st.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(st.grad.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2.0 ** -8, atol=1e-5)


# ---------------------------------------------------------------------------
# (d) K7 plain and the training rulebooks: exact
# ---------------------------------------------------------------------------

def _grid_voxels(seed, d, cap):
    """A device voxelization of random proposal-grid points (both sides)."""
    rng = np.random.RandomState(seed)
    n = 3000
    c = np.concatenate([rng.randint(0, 5, (n, 1)),
                        rng.randint(0, d, (n, 3))], 1).astype(np.int32)
    valid = rng.rand(n) < 0.9
    jv, jkey = jvox.voxelize_linear(jnp.asarray(c), jnp.asarray(valid),
                                    jnp.asarray([d, d, d]), cap)
    tv, tkey = vox.voxelize_linear(_t(c), _t(valid), (d, d, d), cap)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))
    return (tv, tkey), (jv, jkey)


def test_rules_join_plain():
    (tv, tkey), _ = _grid_voxels(40, 10, 4096)
    keys = torch.where(tv.vox_valid, tkey, INT_MAX)
    xyz = tv.vox_coords[:, 1:].contiguous()
    dims = torch.tensor([10, 10, 10], dtype=torch.int32)
    offs = np.delete(rb.SUBM_OFFSETS, rb.CENTER_TAP, axis=0)
    ref = jjk.xla_rules_join(jnp.asarray(keys.numpy()),
                             jnp.asarray(xyz.numpy()), jnp.asarray(dims),
                             offs)
    out = jk.sorted_key_rules_join(keys, xyz, dims, offs)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int((out >= 0).sum()) > 1000


def test_rules_join_vs_pallas():
    """K7 (its plain version on the CPU) against the reference's Pallas
    rulebook join in interpret mode, on a table with dense tiles (two full
    10^3 grids), sparse tiles and a padded tail."""
    rng = np.random.RandomState(42)
    d, m = 10, 4096
    key = np.concatenate([np.arange(2000),
                          np.sort(rng.choice(np.arange(2000, 40000), 1200,
                                             replace=False))])
    keys = np.full(m, INT_MAX, np.int32)
    keys[:len(key)] = key
    r = np.where(keys == INT_MAX, 0, keys) % d ** 3
    xyz = np.stack([r // d ** 2, (r // d) % d, r % d], 1).astype(np.int32)
    offs = tuple(map(tuple, np.delete(rb.SUBM_OFFSETS, rb.CENTER_TAP,
                                      axis=0).tolist()))
    dims = np.array([d, d, d], np.int32)
    ref = jjk.sorted_key_rules_join(jnp.asarray(keys), jnp.asarray(xyz),
                                    jnp.asarray(dims), offs, window_w=768,
                                    interpret=True, force_kernel=True)
    np.testing.assert_array_equal(
        np.asarray(ref), np.asarray(jjk.xla_rules_join(
            jnp.asarray(keys), jnp.asarray(xyz), jnp.asarray(dims), offs)))
    out = jk.sorted_key_rules_join(_t(keys), _t(xyz), _t(dims), offs)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int((out[:, :2000] >= 0).sum()) > 20 * 1500
    assert int((out[:, 2000:] >= 0).sum()) > 0


@pytest.mark.parametrize('cap', [1024, 4096], ids=['truncating', 'padded'])
def test_training_rulebooks_exact(cap):
    (tv, tkey), (jv, jkey) = _grid_voxels(41, 10, cap)
    dims = (10, 10, 10)
    rules = rb.build_subm_rules_linear(tkey, tv.vox_coords, tv.vox_valid,
                                       torch.tensor(dims, dtype=torch.int32))
    ref = jrb.build_subm_rules_linear(jkey, jv.vox_coords, jv.vox_valid,
                                      jnp.asarray(dims, jnp.int32))
    np.testing.assert_array_equal(rules.numpy(), np.asarray(ref))
    out = rb.build_downsample_linear(tv.vox_coords, tv.vox_valid, dims, 512)
    ref = jrb.build_downsample_linear(jv.vox_coords, jv.vox_valid,
                                      jnp.asarray(dims, jnp.int32), 512)
    names = ('vox_coords', 'vox_valid', 'n_voxels', 'down_rules',
             'parent_idx', 'child_tap', 'ckey', 'dims')
    for name, a, b in zip(names, out, ref):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


# ---------------------------------------------------------------------------
# (e) the masked batch norm in train mode
# ---------------------------------------------------------------------------

def test_masked_batch_norm_train():
    rng = np.random.RandomState(50)
    x = (rng.randn(300, 6) * 3 + 1).astype(np.float32)
    mask = rng.rand(300) < 0.7
    scale = rng.rand(6).astype(np.float32) + 0.5
    bias = rng.randn(6).astype(np.float32)
    mean0 = rng.randn(6).astype(np.float32)
    var0 = rng.rand(6).astype(np.float32) + 0.5
    jbn = JBN(6)
    y_ref, mut = jbn.apply(
        {'params': {'scale': scale, 'bias': bias},
         'batch_stats': {'mean': mean0, 'var': var0}},
        jnp.asarray(x), jnp.asarray(mask), True, mutable=['batch_stats'])
    bn = MaskedBatchNorm(6)
    bn.load_state_dict({'scale': _t(scale), 'bias': _t(bias),
                        'mean': _t(mean0), 'var': _t(var0)})
    y = bn.train()(_t(x), _t(mask))
    _close(y.detach(), y_ref, 1e-5, 'y')
    _close(bn.mean, mut['batch_stats']['mean'], 1e-6, 'running mean')
    _close(bn.var, mut['batch_stats']['var'], 1e-6, 'running var')
    # eval mode normalizes with the running statistics and updates nothing
    before = bn.var.clone()
    y_eval = bn.eval()(_t(x))
    y_eval_ref = jbn.apply(
        {'params': {'scale': scale, 'bias': bias},
         'batch_stats': {k: np.asarray(v)
                         for k, v in mut['batch_stats'].items()}},
        jnp.asarray(x), jnp.asarray(mask), False)
    _close(y_eval.detach(), y_eval_ref, 1e-5, 'eval')
    assert torch.equal(before, bn.var)


# ---------------------------------------------------------------------------
# (f) masks and the instance loss on a made-up CSR
# ---------------------------------------------------------------------------

def _made_up_csr(seed):
    """Proposals as a CSR over 600 points with 9 gt instances, one of an
    ignored class; 60 pad entries."""
    rng = np.random.RandomState(seed)
    n_pts, n_inst, p_max, s = 600, 12, 16, 1024
    inst = rng.randint(-1, 9, n_pts).astype(np.int32)
    inst[inst < 0] = -100
    pointnum = np.zeros(n_inst, np.int32)
    for i in range(9):
        pointnum[i] = (inst == i).sum()
    icls = np.full(n_inst, -100, np.int32)
    icls[:9] = rng.randint(0, 4, 9)
    icls[4] = -100                                  # an ignored-class gt
    ivalid = np.arange(n_inst) < 9
    n_prop = 11
    pt, seg = [], []
    for p in range(n_prop):       # proposals mostly made of one instance
        members = np.flatnonzero(inst == p % 9)
        others = rng.choice(n_pts, rng.randint(0, 30), replace=False)
        keep = members[rng.rand(len(members)) < rng.rand() * 0.6 + 0.4]
        pts = np.unique(np.concatenate([keep, others]))
        pt.append(pts)
        seg.append(np.full(len(pts), p))
    pt, seg = np.concatenate(pt), np.concatenate(seg)
    n_e = len(pt)
    entry_pt = np.full(s, n_pts - 1, np.int32)
    entry_seg = np.full(s, p_max, np.int32)
    entry_pt[:n_e], entry_seg[:n_e] = pt, seg
    entry_valid = np.arange(s) < n_e
    arrays = dict(entry_pt=entry_pt, entry_seg=entry_seg,
                  entry_valid=entry_valid, n_proposals=np.int32(n_prop),
                  prop_valid=np.arange(p_max) < n_prop)
    scores = dict(cls=rng.randn(p_max, 5).astype(np.float32),
                  mask=rng.randn(s, 5).astype(np.float32) * 2,
                  iou=rng.rand(p_max, 5).astype(np.float32))
    gt = dict(instance_labels=inst, instance_pointnum=pointnum,
              instance_cls=icls, instance_valid=ivalid)
    return arrays, scores, gt


def test_masks_exact():
    arrays, scores, gt = _made_up_csr(60)
    a = {k: _t(v) for k, v in arrays.items()}
    g = {k: _t(v) for k, v in gt.items()}
    ja = {k: jnp.asarray(v) for k, v in arrays.items()}
    jg = {k: jnp.asarray(v) for k, v in gt.items()}
    ious = msk.mask_iou_on_cluster(a['entry_pt'], a['entry_seg'],
                                   a['entry_valid'], g['instance_labels'],
                                   g['instance_pointnum'], 16)
    jious = jmsk.mask_iou_on_cluster(ja['entry_pt'], ja['entry_seg'],
                                     ja['entry_valid'], jg['instance_labels'],
                                     jg['instance_pointnum'], 16)
    _close(ious, jious, 1e-6, 'iou on cluster')
    sig = torch.sigmoid(_t(scores['mask'][:, 2]))
    pred = msk.mask_iou_on_pred(a['entry_pt'], a['entry_seg'],
                                a['entry_valid'], g['instance_labels'],
                                g['instance_pointnum'], sig, 16)
    jpred = jmsk.mask_iou_on_pred(ja['entry_pt'], ja['entry_seg'],
                                  ja['entry_valid'], jg['instance_labels'],
                                  jg['instance_pointnum'],
                                  jnp.asarray(sig.numpy()), 16)
    _close(pred, jpred, 1e-6, 'iou on pred')
    lab = msk.mask_label(a['entry_pt'], a['entry_seg'], a['entry_valid'],
                         g['instance_labels'], g['instance_cls'], ious, 0.5)
    jlab = jmsk.mask_label(ja['entry_pt'], ja['entry_seg'],
                           ja['entry_valid'], jg['instance_labels'],
                           jg['instance_cls'], jious, 0.5)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    assert (lab.numpy() == 1).sum() > 50 and (lab.numpy() == 0).sum() > 20


@pytest.mark.parametrize('low_quality', [False, True])
def test_instance_loss(low_quality):
    arrays, scores, gt = _made_up_csr(61)
    cfg = Config(dict(instance_classes=4, ignore_label=-100,
                      train_cfg=dict(pos_iou_thr=0.5,
                                     match_low_quality=low_quality,
                                     min_pos_thr=0.1)))
    props = Proposals(**{k: _t(v) for k, v in arrays.items()})
    jprops = JProposals(**{k: jnp.asarray(v) for k, v in arrays.items()})
    cls, mask, iou = (_t(scores[k]).requires_grad_(True)
                      for k in ('cls', 'mask', 'iou'))
    out = instance_loss(cls, mask, iou, props,
                        *(_t(gt[k]) for k in ('instance_labels',
                                              'instance_pointnum',
                                              'instance_cls',
                                              'instance_valid')), cfg)

    def ref_fn(c, m, i):
        return jsg.instance_loss(c, m, i, jprops,
                                 *(jnp.asarray(gt[k]) for k in (
                                     'instance_labels', 'instance_pointnum',
                                     'instance_cls', 'instance_valid')), cfg)

    ref = ref_fn(*(jnp.asarray(scores[k]) for k in ('cls', 'mask', 'iou')))
    for k in ref:
        _close(out[k].detach(), ref[k], 1e-6, k)
    assert float(out['num_pos']) >= 3 and float(out['mask_loss']) > 0
    total = sum(v for k, v in out.items() if 'loss' in k)
    total.backward()
    rgrads = jax.grad(lambda *a: sum(v for k, v in ref_fn(*a).items()
                                     if 'loss' in k), argnums=(0, 1, 2))(
        *(jnp.asarray(scores[k]) for k in ('cls', 'mask', 'iou')))
    for t, r, name in zip((cls, mask, iou), rgrads, ('cls', 'mask', 'iou')):
        _close(t.grad, r, 1e-6, f'd/d {name}')


# ---------------------------------------------------------------------------
# (g, h) the slice: one train step against jax.value_and_grad(loss_forward)
# ---------------------------------------------------------------------------

def _flax_tree(net: SoftGroupNet) -> dict:
    """The port's parameters and batch-norm buffers as a flax variable
    tree (numpy leaves): the inverse of ``from_jax_variables``."""
    tree = {'params': {}, 'batch_stats': {}}
    items = [('params', k, v) for k, v in net.named_parameters()]
    items += [('batch_stats', k, v) for k, v in net.named_buffers()]
    for coll, key, val in items:
        node = tree[coll]
        *path, leaf = key.split('.')
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val.detach().numpy().copy()
    return tree


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _leaves(v, prefix + (k,))
        else:
            yield '.'.join(prefix + (k,)), np.asarray(v)


def _jax_step(jnet, variables, jb, cfg, caps, rng, frozen=()):
    """The reference's loss and gradients of one train step
    (``parallel/mesh.py`` single-device ``device_grads``): (loss, logs, new
    batch_stats, grads of the trainable modules)."""
    params = variables['params']
    trainable = {k: v for k, v in params.items() if k not in frozen}
    fixed = {k: v for k, v in params.items() if k in frozen}

    def loss_fn(tp, batch_stats, batch, key):
        (loss, logs), mut = jnet.apply(
            {'params': {**fixed, **tp}, 'batch_stats': batch_stats},
            batch, cfg, caps, key, method=jnet.loss_forward,
            mutable=['batch_stats'])
        return loss, (logs, mut['batch_stats'])

    (loss, (logs, new_bs)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(trainable, variables['batch_stats'], jb, rng)
    return float(loss), {k: float(v) for k, v in logs.items()}, new_bs, grads


def _slice(batches, frozen):
    tb, jb = batches
    cfg = tiny_cfg()
    caps = Capacities(**CAPS)
    net = SoftGroupNet(channels=8, num_blocks=3, semantic_classes=6,
                       instance_classes=4, bf16=False,
                       generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        # a zero offset head keeps the shifted points on the 1/64 grid
        net.offset_linear.final_kernel.zero_()
        net.offset_linear.final_bias.zero_()
        for name, buf in net.named_buffers():   # off their init values
            buf.add_(torch.rand(buf.shape,
                                generator=torch.Generator().manual_seed(
                                    len(name))) * 0.1)
    variables = _flax_tree(net)
    # the port's net takes the reference's variables through the converter
    net = SoftGroupNet(channels=8, num_blocks=3, semantic_classes=6,
                       instance_classes=4, bf16=False)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    jnet = JNet(channels=8, num_blocks=3, semantic_classes=6,
                instance_classes=4, bf16=False, fixed_modules=frozen)
    rng = jax.random.PRNGKey(3)
    rand = np.stack([np.asarray(jax.random.uniform(rng, (3,))),
                     np.asarray(jax.random.uniform(jax.random.fold_in(rng, 1),
                                                   (3,)))])
    ref = _jax_step(jnet, variables, jb, cfg, JCaps(**CAPS), rng, frozen)
    state = entry.build_train_state(net, cfg, caps, frozen)
    logs = state.step(tb, rand=_t(rand))
    return state.net, logs, ref, variables


@pytest.fixture(scope='module')
def all_params(batches):
    return _slice(batches, ())


@pytest.fixture(scope='module')
def frozen_backbone(batches):
    return _slice(batches, FROZEN)


def test_slice_losses(all_params):
    _, logs, (loss, ref_logs, *_), _ = all_params
    assert set(logs) == set(ref_logs) == set(LOG_KEYS)
    for k in LOG_KEYS:
        _close(float(logs[k]), ref_logs[k], 1e-4, k)
    _close(float(logs['loss']), loss, 1e-4, 'total')
    # the refinement losses are live: positives, a mask loss
    assert ref_logs['num_pos'] > 0 and ref_logs['mask_loss'] > 0


def test_slice_gradients(all_params):
    """Every gradient leaf within 1e-4 x max(1, max|ref|): the same math,
    summed in another order."""
    net, _, (_, _, _, grads), _ = all_params
    ref = dict(_leaves(grads))
    port = {k: p.grad for k, p in net.named_parameters()}
    assert set(port) == set(ref)
    for k, r in ref.items():
        assert port[k] is not None, k
        _close_scaled(port[k], r, 1e-4, k)
    for m in ('input_conv', 'unet', 'tiny_unet', 'cls_linear',
              'semantic_linear', 'mask_linear', 'iou_score_linear'):
        assert any(np.abs(r).max() > 0 for k, r in ref.items()
                   if k.startswith(m + '.')), m


def test_slice_batch_stats(all_params):
    net, _, (_, _, new_bs, _), _ = all_params
    ref = dict(_leaves(new_bs))
    bufs = dict(net.named_buffers())
    assert set(bufs) == set(ref)
    for k, r in ref.items():
        _close(bufs[k], r, 1e-5, k)


def _adam_from(before, net) -> dict:
    """optax.adam(0.004)'s first step from the parameters ``before`` with
    the port's own gradients (the reference's update rule)."""
    params = {k: jnp.asarray(v) for k, v in _leaves(before['params'])}
    grads = {k: jnp.asarray(p.grad.numpy()) for k, p in
             net.named_parameters() if p.grad is not None}
    params = {k: params[k] for k in grads}
    tx = optax.adam(0.004)
    updates, _ = tx.update(grads, tx.init(params), params)
    return {k: np.asarray(v) for k, v in
            optax.apply_updates(params, updates).items()}


def test_slice_adam_step(all_params):
    """The updated parameters against optax.adam(0.004) applied to the
    port's gradients (which the test above holds to the reference's).  The
    first Adam step moves each entry by ~lr * grad / (|grad| + 1e-8), so
    entries whose gradient is ~1e-8 amplify the last bits of the gradient:
    the update rule is compared on equal gradients, at 1e-6."""
    net, _, _, before = all_params
    want = _adam_from(before, net)
    old = dict(_leaves(before['params']))
    assert set(want) == {k for k, _ in net.named_parameters()}
    for k, p in net.named_parameters():
        _close(p.detach(), want[k], 1e-6, k)
        # a leaf moves exactly when some entry of its gradient is nonzero
        assert (np.array_equal(p.detach().numpy(), old[k])
                == (not p.grad.any())), k


def test_slice_frozen_backbone(frozen_backbone):
    """The second ScanNet stage: the backbone is frozen (no gradient, no
    update, its batch norms in eval mode with their statistics kept); the
    refinement trains and matches the reference's frozen step."""
    net, logs, (_, ref_logs, new_bs, grads), before = frozen_backbone
    for k in LOG_KEYS:
        _close(float(logs[k]), ref_logs[k], 1e-4, k)
    ref = dict(_leaves(grads))
    old = dict(_leaves(before['params']))
    want = _adam_from(before, net)
    bufs = dict(net.named_buffers())
    old_bs = dict(_leaves(before['batch_stats']))
    for k, p in net.named_parameters():
        top = k.split('.')[0]
        if top in FROZEN:
            assert p.grad is None and not p.requires_grad, k
            assert np.array_equal(p.detach().numpy(), old[k]), k
        else:
            r = ref[k]
            _close_scaled(p.grad, r, 1e-4, k)
            _close(p.detach(), want[k], 1e-6, k)
    ref_bs = dict(_leaves(new_bs))
    for k, b in bufs.items():
        _close(b, ref_bs[k], 1e-5, k)
        if k.split('.')[0] in BACKBONE_NORM_MODULES:
            assert np.array_equal(b.numpy(), old_bs[k]), k
    assert ref_logs['num_pos'] > 0


# ---------------------------------------------------------------------------
# the learning-rate schedule against the reference's
# ---------------------------------------------------------------------------

def test_cosine_schedule():
    ref = jopt.cosine_after_step_schedule(0.004, 50, 128, 300)
    port = optim.cosine_after_step_schedule(0.004, 50, 128, 300)
    for step in (0, 1, 14999, 15000, 15001, 20000, 38399, 38400, 50000):
        _close(port(step), float(ref(step)), 1e-6, str(step))


# ---------------------------------------------------------------------------
# (i) the entry point's config is the yaml's model section
# ---------------------------------------------------------------------------

def test_train_cfg_is_the_yaml():
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), 'configs', 'softgroup',
            'softgroup_scannet.yaml')) as f:
        model = yaml.safe_load(f)['model']
    assert entry.train_cfg().to_dict() == model
