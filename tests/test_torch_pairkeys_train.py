"""Parity of the port's training step on pair-key model sections with the
JAX reference on the CPU: one ``jax.jit(jax.value_and_grad(loss_forward))``
of a tiny S3DIS-like section (here) and a tiny STPLS3D-like section
(``tests/test_torch_pairkeys_stpls3d.py``, the same tests in a file of its
own, so that the two compilations run on two workers) against the port's
``loss_forward`` -> ``backward`` -> Adam step, as
``tests/test_torch_train.py``'s slice does for the ScanNet section.

Both sections leave ``grouping_cfg.pair_keys`` at its default, so the
training grouping clusters on int64 cell keys (the reference's pairs of
int32 keys).  The STPLS3D-like section also has its yaml's
``with_coords: false`` (three input channels), ``semantic_weight``,
``match_low_quality`` with ``min_pos_thr`` and relative class-size
thresholds (``class_numpoint_mean``).

The batch is ``tests/torch_helpers.py``'s two tiny scenes (coordinates on a
1/64 grid) and the offset head is zeroed, so grouping is exact.
Tolerances (``test_torch_train.py``'s): losses within 1e-4, gradients
within 1e-4 x max(1, max|ref|), running statistics within 1e-5, the Adam
update on the port's own gradients within 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from softgroup_tpu.data.padding import build_scene_batch as jax_batch
from softgroup_tpu.model.softgroup import Capacities as JCaps
from softgroup_tpu.model.softgroup import SoftGroupNet as JNet
from softgroup_tpu_torch import entry
from softgroup_tpu_torch.data.padding import build_scene_batch
from softgroup_tpu_torch.model.softgroup import Capacities, SoftGroupNet
from softgroup_tpu_torch.ops import grouping
from softgroup_tpu_torch.util.convert import from_jax_variables

from test_torch_train import (LOG_KEYS, _adam_from, _close, _close_scaled,
                              _flax_tree, _jax_step, _leaves)
from torch_helpers import CAPS, TINY, batch_args, tiny_cfg, tiny_data

torch.set_num_threads(1)

PAIR_GROUPING = {k: v for k, v in TINY['grouping_cfg'].items()
                 if k != 'pair_keys'}
SECTIONS = {
    # S3DIS: the default pair keys, colour and coordinates in
    's3dis': dict(TINY, grouping_cfg=PAIR_GROUPING),
    # STPLS3D: colour only in, class weights, low-quality matches,
    # thresholds relative to each class's mean size
    'stpls3d': dict(
        TINY, with_coords=False,
        grouping_cfg=dict(PAIR_GROUPING, npoint_thr=0.05,
                          class_numpoint_mean=[-1.0, 400.0, 200.0, 300.0,
                                               100.0, 250.0]),
        semantic_weight=[1.0, 1.0, 4.4, 2.2, 1.8, 2.5],
        train_cfg=dict(TINY['train_cfg'], match_low_quality=True,
                       min_pos_thr=0.1)),
}


def _slice(kind):
    """One step of the section ``kind`` on both sides from one set of
    weights (a seeded port init carried across as a flax tree): (the
    port's net after its step, its logs, the reference's (loss, logs, new
    batch stats, grads), the initial variables, the cell-key dtypes of the
    port's grouping)."""
    cfg = tiny_cfg(SECTIONS[kind])
    with_coords = cfg.with_coords
    data = tiny_data()
    caps = Capacities(**CAPS)
    tb = build_scene_batch(*batch_args(data), caps, num_levels=3,
                           with_coords=with_coords, device='cpu')
    jb = jax_batch(*batch_args(data), JCaps(**CAPS), num_levels=3,
                   with_coords=with_coords)
    cin = 6 if with_coords else 3
    assert tb.vox_in.shape[1] == cin
    net = SoftGroupNet(channels=8, num_blocks=3, semantic_classes=6,
                       instance_classes=4, bf16=False, in_channels=cin,
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
    net = entry.build_net(cfg, device='cpu', bf16=False)
    net.load_state_dict(from_jax_variables(variables), strict=True)
    jnet = JNet(channels=8, num_blocks=3, semantic_classes=6,
                instance_classes=4, bf16=False)
    rng = jax.random.PRNGKey(3)
    rand = np.stack([np.asarray(jax.random.uniform(rng, (3,))),
                     np.asarray(jax.random.uniform(jax.random.fold_in(rng, 1),
                                                   (3,)))])
    ref = _jax_step(jnet, variables, jb, cfg, JCaps(**CAPS), rng)
    state = entry.build_train_state(net, cfg, caps)
    keys = []
    join = grouping.cell_neighbor_join

    def record(*a):
        keys.append(a[0].dtype)
        return join(*a)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(grouping, 'cell_neighbor_join', record)
        logs = state.step(tb, rand=torch.from_numpy(rand))
    return state.net, logs, ref, variables, keys


@pytest.fixture(scope='module')
def stepped():
    return 's3dis', _slice('s3dis')


def test_pair_key_losses(stepped):
    """Every logged loss and count within 1e-4 of the reference's; the
    grouping joined int64 cell keys; the refinement has positives."""
    kind, (_, logs, (loss, ref_logs, *_), _, keys) = stepped
    assert keys == [torch.int64]
    assert set(logs) == set(ref_logs) == set(LOG_KEYS)
    for k in LOG_KEYS:
        _close(float(logs[k]), ref_logs[k], 1e-4, k)
    _close(float(logs['loss']), loss, 1e-4, 'total')
    assert ref_logs['num_pos'] > 0 and ref_logs['mask_loss'] > 0


def test_pair_key_gradients(stepped):
    """Every gradient leaf within 1e-4 x max(1, max|ref|)."""
    kind, (net, _, (_, _, _, grads), _, _) = stepped
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


def test_pair_key_batch_stats(stepped):
    kind, (net, _, (_, _, new_bs, _), _, _) = stepped
    ref = dict(_leaves(new_bs))
    bufs = dict(net.named_buffers())
    assert set(bufs) == set(ref)
    for k, r in ref.items():
        _close(bufs[k], r, 1e-5, k)


def test_pair_key_adam_step(stepped):
    """The updated parameters against optax.adam(0.004) applied to the
    port's gradients, at 1e-6 (``test_slice_adam_step``'s reason)."""
    kind, (net, _, _, before, _) = stepped
    want = _adam_from(before, net)
    old = dict(_leaves(before['params']))
    assert set(want) == {k for k, _ in net.named_parameters()}
    for k, p in net.named_parameters():
        _close(p.detach(), want[k], 1e-6, k)
        assert (np.array_equal(p.detach().numpy(), old[k])
                == (not p.grad.any())), k
