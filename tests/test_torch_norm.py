"""Masked batch norm and ReLU (``ops/norm_kernel.py``) on the CPU: the
closed-form backward the kernels compute (``csrc/norm.cu``), written here
in PyTorch, against autograd of the module's formula
(``batch_norm_plain``) in f64, and ``gradcheck``; the module's ``relu``
argument; the tile plan the kernels take; the checks the card runs
(``time_kernels.bn_faults``) against broken batch norms."""

from __future__ import annotations

import pytest
import torch

from softgroup_tpu_torch import time_kernels as tk
from softgroup_tpu_torch.model.blocks import MaskedBatchNorm
from softgroup_tpu_torch.ops import norm_kernel as nk
from softgroup_tpu_torch.util import trace

EPS, MOMENTUM = 1e-4, 0.1


class _ClosedForm(torch.autograd.Function):
    """``batch_norm_plain``'s output and running buffers; the backward in
    the closed form of ``csrc/norm.cu``: g = dy where the output is
    positive (with the ReLU), x^ = (x - mean) * rstd; dbias = sum g and
    dscale = sum g x^ over every row; dx = scale * rstd * (g - valid *
    (sum g + x^ sum g x^) / n), eval scale * rstd * g."""

    @staticmethod
    def forward(ctx, x, mask, scale, bias, run_mean, run_var, training,
                relu):
        xf = x.to(torch.float64 if x.dtype == torch.float64
                  else torch.float32)
        if training:
            m = mask.to(xf.dtype)[:, None]
            n = m.sum().clamp(min=1.0)
            mean = (xf * m).sum(0) / n
            rstd = (((xf - mean).square() * m).sum(0) / n + EPS).rsqrt()
        else:
            n, mean, rstd = None, run_mean.clone(), (run_var + EPS).rsqrt()
        y = nk.batch_norm_plain(x, mask, scale, bias, run_mean, run_var,
                                training, EPS, MOMENTUM, relu)
        ctx.save_for_backward(x, mask, scale, mean, rstd, y)
        ctx.n, ctx.relu = n, relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mask, scale, mean, rstd, y = ctx.saved_tensors
        xh = (x.to(mean.dtype) - mean) * rstd
        g = dy.to(mean.dtype)
        if ctx.relu:
            g = torch.where(y > 0, g, 0.0)
        sg, sgx = g.sum(0), (g * xh).sum(0)
        dx = g
        if ctx.n is not None:
            dx = g - mask.to(g.dtype)[:, None] * (sg + xh * sgx) / ctx.n
        return ((scale * rstd * dx).to(x.dtype), None, sgx.to(scale.dtype),
                sg.to(scale.dtype), None, None, None, None)


def closed_form(x, mask, scale, bias, run_mean, run_var, training, eps,
                momentum, relu):
    assert (eps, momentum) == (EPS, MOMENTUM)
    return _ClosedForm.apply(x, mask, scale, bias, run_mean, run_var,
                             training, relu)


def _case(mask_kind: str, v: int = 37, c: int = 6, seed: int = 0,
          dtype=torch.float64):
    """x (v, c) off zero and of unequal scales, the mask, scale, bias,
    running buffers, and an upstream gradient."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(v, c, generator=g, dtype=torch.float64)
         * torch.linspace(0.5, 3.0, c, dtype=torch.float64)
         + torch.linspace(-2.0, 5.0, c, dtype=torch.float64)).to(dtype)
    mask = {'partial': torch.rand(v, generator=g) < 0.6,
            'padded tail': torch.arange(v) < v * 2 // 3,
            'one valid': torch.arange(v) == v // 2,
            'none valid': torch.zeros(v, dtype=torch.bool),
            'all valid': torch.ones(v, dtype=torch.bool)}[mask_kind]
    scale = torch.rand(c, generator=g, dtype=torch.float64) + 0.5
    bias = torch.randn(c, generator=g, dtype=torch.float64)
    mean = torch.randn(c, generator=g, dtype=torch.float64)
    var = torch.rand(c, generator=g, dtype=torch.float64) + 0.5
    dy = torch.randn(v, c, generator=g, dtype=torch.float64).to(dtype)
    return x, mask, scale, bias, mean, var, dy


def _run(fn, x, mask, scale, bias, mean, var, dy, training, relu):
    """Output, running buffers and the gradients of x, scale and bias."""
    x = x.clone().requires_grad_(True)
    scale = scale.clone().requires_grad_(True)
    bias = bias.clone().requires_grad_(True)
    mean, var = mean.clone(), var.clone()
    out = fn(x, mask, scale, bias, mean, var, training, EPS, MOMENTUM, relu)
    out.backward(dy)
    return out.detach(), mean, var, x.grad, scale.grad, bias.grad


@pytest.mark.parametrize('relu', [True, False], ids=['relu', 'no relu'])
@pytest.mark.parametrize('mode,mask_kind', [
    ('train', 'partial'), ('train', 'padded tail'), ('train', 'one valid'),
    ('train', 'none valid'), ('train', 'all valid'), ('eval', 'partial')])
def test_function_matches_module_autograd(mode, mask_kind, relu):
    """In f64 the kernels' closed form gives autograd's dx, dscale and
    dbias of the module's formula (beside its output and running
    buffers)."""
    case = _case(mask_kind)
    training = mode == 'train'
    want = _run(nk.batch_norm_plain, *case, training, relu)
    got = _run(closed_form, *case, training, relu)
    for name, w, h in zip(('out', 'mean', 'var', 'dx', 'dscale', 'dbias'),
                          want, got):
        assert h.dtype == w.dtype, name
        torch.testing.assert_close(h, w, rtol=1e-10, atol=1e-10,
                                   msg=f'{name} ({mode}, {mask_kind})')
    if relu:   # the gate closes somewhere, so the test sees it
        assert (want[0] == 0).any() and (want[0] > 0).any()


@pytest.mark.parametrize('mode,mask_kind,relu', [
    ('train', 'partial', True), ('train', 'padded tail', False),
    ('train', 'one valid', True), ('eval', 'partial', True)])
def test_function_gradcheck(mode, mask_kind, relu):
    x, mask, scale, bias, mean, var, _ = _case(mask_kind, v=9, c=3, seed=1)
    inputs = (x.requires_grad_(True), scale.requires_grad_(True),
              bias.requires_grad_(True))

    def fn(x_, s_, b_):
        return closed_form(x_, mask, s_, b_, mean.clone(), var.clone(),
                           mode == 'train', EPS, MOMENTUM, relu)
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-6)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_function_in_working_types(dtype):
    """bf16 and f32 (the card's types): the closed form gives autograd's
    gradients to one rounding, dx in x's type; the module's formula
    returns x's type, and the parameters' gradients and statistics stay
    f32."""
    x, mask, scale, bias, mean, var, dy = _case('partial', v=300, c=16,
                                                dtype=dtype)
    f32 = [t.float() for t in (scale, bias, mean, var)]
    want = _run(nk.batch_norm_plain, x, mask, *f32, dy, True, True)
    got = _run(closed_form, x, mask, *f32, dy, True, True)
    assert want[0].dtype == dtype and want[3].dtype == dtype
    assert all(t.dtype == torch.float32 for t in want[1:3] + want[4:])
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
    assert got[0].dtype == dtype and got[3].dtype == dtype
    for name, w, h in zip(('out', 'mean', 'var', 'dx', 'dscale', 'dbias'),
                          want, got):
        tol = ulp * max(1.0, float(w.abs().max()))
        assert float((h.double() - w.double()).abs().max()) <= tol, name


@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
def test_module_relu_argument(training):
    """``relu=True`` is the module's output through ``torch.relu``, bit for
    bit, with the same running buffers; without it the module is as it
    was."""
    x, mask, *_ = _case('partial', dtype=torch.float32)
    a, b = MaskedBatchNorm(6), MaskedBatchNorm(6)
    with torch.no_grad():
        for m in (a, b):
            m.scale.copy_(torch.linspace(0.5, 1.5, 6))
            m.bias.copy_(torch.linspace(-1.0, 1.0, 6))
    a.train(training)
    b.train(training)
    fused = a(x, mask, relu=True)
    plain = torch.relu(b(x, mask))
    assert torch.equal(fused, plain)
    assert torch.equal(a.mean, b.mean) and torch.equal(a.var, b.var)
    if training:
        assert not torch.equal(a.mean, torch.zeros(6))


@pytest.mark.parametrize('v,c,dtype,vec,rpb,nblk', [
    (524288, 32, torch.bfloat16, 8, 64, 512),
    (262144, 64, torch.bfloat16, 8, 32, 512),
    (8192, 224, torch.bfloat16, 8, 9, 114),
    (1048576, 32, torch.bfloat16, 8, 64, 512),
    (16384, 384, torch.bfloat16, 8, 5, 410),
    (524288, 16, torch.bfloat16, 8, 128, 512),
    (524288, 32, torch.float32, 4, 32, 512),
    (3001, 19, torch.bfloat16, 1, 13, 29),
    (0, 32, torch.bfloat16, 8, 64, 1)])
def test_tile_plan(v, c, dtype, vec, rpb, nblk):
    """The tile the kernels take (csrc/norm.cu tile_ok): 16-byte vectors
    where C allows them, at most 512 threads a block, every row covered,
    about 4 blocks an SM on the big levels and 8 rows a thread at least;
    planned once for a shape."""
    x = torch.empty((v, c), dtype=dtype)
    tile = nk._tile(x)
    assert list(tile) == [nk._DTYPES[dtype], v, c, vec, rpb, tile[5], nblk]
    assert nk._tile(torch.empty((v, c), dtype=dtype)) is tile
    rows = tile[5]
    assert rows % rpb == 0 and rows >= nk._ROWS_A_THREAD * rpb
    assert nblk * rows >= v and (nblk - 1) * rows < max(v, 1)
    assert (c // vec) * rpb <= nk._MAX_THREADS


def test_tile_plan_unaligned():
    """An address off 16 bytes, of x or of the gradient beside it, takes
    one channel a thread."""
    base = torch.empty(4097 * 32, dtype=torch.bfloat16)
    x = base[1:4096 * 32 + 1].view(4096, 32)
    aligned = base[:4096 * 32].view(4096, 32)
    assert nk._tile(x)[3] == 1
    assert nk._tile(aligned)[3] == 8
    assert nk._tile(aligned, x)[3] == 1


def test_counters_and_launches():
    """The CPU takes the plain version: no kernel, so neither the kernel
    counters of an open trace session nor ``launches`` move."""
    x, mask, scale, bias, mean, var, dy = _case('partial')
    before = nk.masked_batch_norm.launches
    with trace.session() as s:
        _run(nk.masked_batch_norm, x, mask, scale, bias, mean, var, dy, True,
             True)
    assert s.counters == {}
    assert nk.masked_batch_norm.launches == before


def test_eval_x_alone():
    """Eval mode with frozen parameters: dx alone in the closed form is
    autograd's."""
    x, mask, scale, bias, mean, var, dy = _case('partial')
    xa = x.clone().requires_grad_(True)
    xb = x.clone().requires_grad_(True)
    nk.batch_norm_plain(xa, mask, scale, bias, mean, var, False, EPS,
                        MOMENTUM, True).backward(dy)
    closed_form(xb, mask, scale, bias, mean, var, False, EPS, MOMENTUM,
                True).backward(dy)
    torch.testing.assert_close(xb.grad, xa.grad, rtol=1e-10, atol=1e-10)


def test_cuda_path_raises_on_the_cpu_tensor_checks():
    """What the kernels do not take is refused before a launch: an f64 x,
    a bf16 scale, a CPU x, a mask of another length, a C wider than a
    block, 2^24 rows."""
    x = torch.zeros(8, 4, dtype=torch.float64)
    f32 = torch.zeros(4)
    with pytest.raises(ValueError):
        nk._check(x, f32)
    with pytest.raises(ValueError):
        nk._check(x.float(), f32.bfloat16())
    with pytest.raises(ValueError):
        nk._check(x.float())
    with pytest.raises(ValueError):
        nk._mask(torch.ones(7, dtype=torch.bool), 8)
    with pytest.raises(ValueError):
        nk._plan(8, 513, torch.float32, False)
    with pytest.raises(ValueError):
        nk._tile_of(2 ** 24, 32, torch.bfloat16, True)


def _ignores_mask(x, mask, *args):
    return nk.batch_norm_plain(x, torch.ones_like(mask), *args)


def _invalid_rows_cut(x, mask, *args):
    """No gradient through the invalid rows."""
    y = nk.batch_norm_plain(x, mask, *args)
    return torch.where(mask[:, None], y, y.detach())


def _frozen_buffers(x, mask, scale, bias, mean, var, *args):
    return nk.batch_norm_plain(x, mask, scale, bias, mean.clone(),
                               var.clone(), *args)


def _ungated(x, mask, scale, bias, mean, var, training, eps, momentum,
             relu):
    y = nk.batch_norm_plain(x, mask, scale, bias, mean, var, training, eps,
                            momentum, False)
    return y + (torch.relu(y) - y).detach() if relu else y


@pytest.mark.parametrize('fault', [_ignores_mask, _invalid_rows_cut,
                                   _frozen_buffers, _ungated],
                         ids=['ignores mask', 'invalid rows cut',
                              'frozen buffers', 'ungated'])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_card_check_catches_faults(fault, dtype):
    """``time_kernels.bn_faults`` (what the card tests and ``chip_smoke``'s
    ``[bn]`` lines hold the kernels to) passes the module's formula and
    refuses batch norms that take the invalid rows into the statistics,
    pass no gradient through the invalid rows, leave the running buffers,
    or pass the gradient through the ReLU's closed gate."""
    case = tk.bn_case('cpu', 3000, 16, dtype, seed=5)
    want = tk.bn_run(nk.batch_norm_plain, *case, True, True)
    same = tk.bn_run(nk.batch_norm_plain, *case, True, True)
    assert tk.bn_faults(same, want, case, True, True, dtype) == []
    got = tk.bn_run(fault, *case, True, True)
    assert tk.bn_faults(got, want, case, True, True, dtype)
