"""K2 (``row_gather``) and the differentiable gather of the port against
the JAX package on the CPU, at the widths of K2's word route (rows not a
multiple of 16 bytes), and the K2 census of ``time_kernels``.

The same numpy inputs go through the reference's function and the port's
(the plain versions, taken because the tensors lie on the CPU).  Gathers
are exact; a gradient sums f32 cotangent rows in another order than the
reference's segment sum, so it is held within rtol 1e-6 (atol 1e-6 for
the sums that cancel to near zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softgroup_tpu.ops import dispatch
from softgroup_tpu.ops.gather_kernel import (gather_rows_segsum_vjp,
                                             monotone_gather_f32,
                                             monotone_window_overflow)
from softgroup_tpu_torch import time_kernels as tk
from softgroup_tpu_torch.model.softgroup import Capacities
from softgroup_tpu_torch.ops import gather_kernel as gk

torch.set_num_threads(1)


@pytest.mark.parametrize('branch', ['segment_sum', 'kernel interpret'])
def test_gather_rows_matches_reference(branch):
    """``gather_rows`` on a (V, 35) f32 source (the proposal-entry gather's
    rows: 3 coordinates + 32 features, 140 bytes) at an unsorted index
    with clamped out-of-range entries, value and gradient, against
    ``gather_rows_segsum_vjp`` (its index pre-clipped, as it asks) on its
    XLA branch and on its kernel branch in interpret mode (V % 256 == 0,
    E % 128 == 0, as the reference's own test runs it)."""
    rng = np.random.RandomState(35)
    v, e, c = 512, 1152, 35
    src = (rng.randn(v, c) * 10).astype(np.float32)
    idx = rng.randint(-20, v + 20, size=e).astype(np.int32)
    ct = rng.randn(e, c).astype(np.float32)
    clipped = np.clip(idx, 0, v - 1)

    def loss(s):
        return jnp.sum(gather_rows_segsum_vjp(s, jnp.asarray(clipped))
                       * jnp.asarray(ct))

    if branch == 'kernel interpret':
        dispatch.set_kernels(True)
        dispatch.set_interpret(True)
    try:
        want = np.asarray(gather_rows_segsum_vjp(jnp.asarray(src),
                                                 jnp.asarray(clipped)))
        want_g = np.asarray(jax.grad(loss)(jnp.asarray(src)))
    finally:
        dispatch.set_kernels(None)
        dispatch.set_interpret(None)
    s = torch.from_numpy(src).requires_grad_(True)
    got = gk.gather_rows(s, torch.from_numpy(idx))
    got.backward(torch.from_numpy(ct))
    assert torch.equal(got.detach(), torch.from_numpy(want.copy()))
    assert s.grad.dtype == torch.float32
    np.testing.assert_allclose(s.grad.numpy(), want_g, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('idx_dtype', [np.int32, np.int64])
@pytest.mark.parametrize('c', [23, 18])
def test_row_gather_matches_monotone_gather_f32(c, idx_dtype):
    """``row_gather`` on (V, 23) and (V, 18) f32 sources (the ++ heads of
    the ScanNet and STPLS3D yamls: 92- and 72-byte rows) at a
    non-decreasing index, against the reference's exact f32 monotone
    gather in interpret mode (E a multiple of 256, V >= 384, each block's
    rows inside its window), bit for bit."""
    rng = np.random.RandomState(c)
    v, e = 640, 1024
    src = (rng.randn(v, c) * 100).astype(np.float32)
    idx = np.sort(rng.randint(0, v, size=e)).astype(np.int32)
    assert int(monotone_window_overflow(jnp.asarray(idx), 256, 384, v)) == 0
    want = np.asarray(monotone_gather_f32(jnp.asarray(src), jnp.asarray(idx),
                                          interpret=True))
    got = gk.row_gather(torch.from_numpy(src),
                        torch.from_numpy(idx.astype(idx_dtype)))
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.from_numpy(want.copy()))
    assert np.array_equal(want, src[idx])


@pytest.mark.parametrize('shape,dtype,offset,route', [
    ((100,), torch.int32, 0, 'narrow'),        # cell labels
    ((100,), torch.int32, 4, 'narrow'),        # a 4-byte view: still aligned
    ((100, 4), torch.float32, 0, '16-byte'),   # grouping entries
    ((100, 32), torch.bfloat16, 0, '16-byte'),  # devoxelize
    ((100, 32), torch.bfloat16, 2, 'word'),    # a view off alignment
    ((100, 2), torch.float32, 4, 'word'),      # 8-byte rows 4 bytes off
    ((100, 3), torch.float32, 0, 'word'),      # ball candidates, 12 bytes
    ((100, 18), torch.float32, 0, 'word'),     # STPLS3D++ heads, 72
    ((100, 19), torch.float32, 0, 'word'),     # STPLS3D entries, 76
    ((100, 23), torch.float32, 0, 'word'),     # ++ heads, 92
    ((100, 35), torch.float32, 0, 'word'),     # proposal entries, 140
    ((100, 19), torch.bfloat16, 0, 'word'),    # mask scores, 38
])
def test_k2_route(shape, dtype, offset, route):
    """``time_kernels.k2_route`` names the route of ``csrc/gather.cu``'s
    ``row_gather`` for each source the paths give K2, and ``at_offset``
    rebuilds a recorded source's alignment with the same values."""
    src = torch.arange(int(np.prod(shape))).reshape(shape).to(dtype)
    moved = tk.at_offset(src, offset)
    assert moved.data_ptr() % 16 == offset
    assert torch.equal(moved, src)
    assert tk.k2_route(moved, offset) == route


def test_gather_bound_counts_reached_rows():
    """K2's bound reads each source row the clamped index reaches once
    (here 3 of 10: rows 0, 4 and 9), the index once, and writes every
    gathered row."""
    src = torch.zeros(10, 3)
    idx = torch.tensor([-5, 4, 4, 0, 12, 9], dtype=torch.int64)
    ms, by = tk.gather_bound(src, idx)
    assert by == 'bytes'
    assert ms == pytest.approx((6 * 8 + (3 + 6) * 12) / 3.35e12 * 1e3)


def test_time_kernels_k2_census(monkeypatch, capsys):
    """K2's census of ``time_kernels`` on one recorded all-params train
    step of the flagship training config (small capacities, the plain
    versions on the CPU, the timer stubbed at 1 ms a call): every
    ``row_gather`` call with its site, route and launches, the
    proposal-entry gather (140-byte rows) forward and its cotangent
    gather inside ``_GatherRows.backward`` on the word route, the path's
    summary, and the backward timed whole and in its parts."""
    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.data.synthetic import make_scene
    caps = Capacities(
        points=16384, voxels=(16384, 8192, 4096, 2048, 1024, 512, 256),
        grouping_points=32768, proposals=32, proposal_entries=32768,
        instances=32, inst_voxels=(4096, 1024), grouping_cells=4096)
    cfg = entry.train_cfg()
    state = entry.build_train_state(
        entry.build_net(cfg, seed=1, device='cpu', bf16=True), cfg, caps)
    batch = entry.build_train_batch(
        [make_scene(np.random.RandomState(7), n_points=8000,
                    n_instances=6)], cfg, caps, device='cpu')
    backward0 = gk._GatherRows.__dict__['backward']
    with tk.K2Recorder() as rec:
        state.step(batch, generator=torch.Generator().manual_seed(0))
    assert gk._GatherRows.__dict__['backward'] is backward0
    assert len(rec.k2) == len(rec.calls['row_gather'])
    calls = tk.k2_calls(rec)
    assert sum(c['launches'] for c in calls) == len(rec.k2)
    by = {(c['site'], c['backward'], tuple(c['args'][0].shape)): c
          for c in calls}
    fwd = by[('gather_kernel', False, (caps.points, 35))]
    bwd = by[('gather_kernel', True, (caps.proposal_entries, 35))]
    assert fwd['route'] == bwd['route'] == 'word'
    assert bwd['args'][1].dtype == torch.int64      # the sort's order
    assert by[('gather_kernel', False, (caps.voxels[0], 32))]['route'] \
        == '16-byte'                                # devoxelize, bf16
    # the proposal-entry gather, the mask gather and the devoxelize
    assert len(rec.backwards) == 3
    assert sorted(b['sorted_idx'] for b in rec.backwards) == [False, False,
                                                              True]
    timed = []

    def fake(lbl, name, fn, card, extra='', device_only=False):
        fn()     # each timed function runs (on the CPU)
        timed.append(name)
        print(name + extra)
        return 1.0
    monkeypatch.setattr(tk, '_timed', fake)
    word = sum(c['launches'] for c in calls if c['route'] == 'word')
    sums = tk.k2_census('train step', rec, 't', 'cpu', device='cpu')
    assert sums == {'word': [word, float(word)],
                    'all': [len(rec.k2), float(len(rec.k2))]}
    tk.k2_summary('train step', sums, 2.5, 't', 'cpu')
    tk.k2_backward_census('train step', rec, 't', 'cpu', device='cpu')
    out = capsys.readouterr().out
    parts = [n.rsplit('True ', 1)[-1].rsplit('False ', 1)[-1]
             for n in timed if ' backward g=' in n]
    assert sorted(parts) == sorted(['cast + clamp + sort', 'K2 gather', 'K6',
                                    'whole'] * 2 + ['K6', 'whole'])
    assert (f'K2 census train step: {len(rec.k2)} launches ({word} word '
            f'route), word route launches x device_ms = {word:.6f} ms, all '
            f'K2 launches x device_ms = {len(rec.k2):.6f} ms, path device '
            f'busy 2.500000 ms') in out
    assert f'K2 census train step gather_kernel backward src=(' \
        f'{caps.proposal_entries}, 35) float32 idx=(' \
        f'{caps.proposal_entries},) int64' in out
    assert 'row_bytes=140 route=word' in out
    assert out.count('equal=True') == len(calls)
    assert 'equal=False' not in out
