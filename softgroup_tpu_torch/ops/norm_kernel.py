"""Masked batch norm and ReLU on Hopper: the statistics, normalise and
backward passes of ``model/blocks.MaskedBatchNorm``.

Replaces no TPU kernel: on the TPU, XLA fuses the reference's batch norm
(``softgroup_tpu/model/blocks.py:MaskedBatchNorm``).  In the port it was a
chain of PyTorch ops, about 30 launches forward and 20 backward a call.
Bound on the H100 by bytes; design note: ``csrc/norm.cu``.  A train-mode
call launches the statistics (per-block Welford partials, then a finalize
that merges them in a fixed order and moves the running buffers in place)
and the normalise pass; its backward a reduction of the gated gradient
(partials, finalize) and the elementwise dx pass; an eval call one pass.
The batch's count stays on the card: no call reads the host.

``masked_batch_norm`` is what the module calls.  On a CPU tensor it takes
``batch_norm_plain`` (the module's formula, autograd through PyTorch's
ops), the one plain version; on a CUDA tensor it launches the kernels,
through ``_BatchNorm`` (whose backward is the kernels too) where a
gradient is wanted, and raises on what they do not take.

A pass is one call into the library with the tile of its shape, planned
once (``_tile``): a thread a 16-byte vector of a row (8 bf16 or 4 f32
channels; one channel where C or an address does not allow it),
``_THREADS`` threads a block, and rows a block for a grid of about
``_FILL_BLOCKS`` blocks, with at least ``_ROWS_A_THREAD`` rows a thread.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..util.trace import count
from . import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}    # channels in 16 bytes
_THREADS = 256          # threads a block, at most (a row's vectors x rows)
_MAX_THREADS = 512      # csrc/norm.cu MAX_THREADS: the widest row it takes
_FILL_BLOCKS = 528      # 4 blocks an SM of an H100 (its sweep in PERF.md)
_ROWS_A_THREAD = 8      # so the small levels' partials stay few
_MAX_ROWS = 2 ** 24     # the count is an f32 on the card: exact below this
_RELU, _EVAL, _PARAMS = 1, 2, 4   # csrc/norm.cu's flags


def batch_norm_plain(x, mask, scale, bias, run_mean, run_var,
                     training: bool, eps: float, momentum: float,
                     relu: bool = False) -> torch.Tensor:
    """The module's formula in PyTorch ops (f32, f64 for f64 ``x``): the
    valid rows' mean and biased variance normalise every row, and the
    running buffers move by ``momentum`` (unbiased variance, max(n - 1,
    1)); eval: the running statistics normalise.  The result in x's type,
    then the ReLU where ``relu``."""
    xf = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
    if training:
        m = mask.to(xf.dtype)[:, None]
        n = m.sum().clamp(min=1.0)
        mean = (xf * m).sum(0) / n
        var = ((xf - mean).square() * m).sum(0) / n
        with torch.no_grad():
            unbiased = var * n / (n - 1.0).clamp(min=1.0)
            run_mean.mul_(1 - momentum).add_(momentum * mean)
            run_var.mul_(1 - momentum).add_(momentum * unbiased)
    else:
        mean, var = run_mean, run_var
    y = ((xf - mean) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)
    return torch.relu(y) if relu else y


def _plan(v: int, c: int, dtype, aligned: bool) -> tuple[int, int, int, int]:
    """(channels a thread, rows of threads a block, rows a block, blocks)
    for a (v, c) pass over ``dtype`` rows at 16-byte addresses or not."""
    vec = _VEC[dtype]
    if c % vec or not aligned:
        vec = 1
    tc = c // vec
    if tc > _MAX_THREADS:
        raise ValueError(f'masked_batch_norm: {c} channels of {dtype} are '
                         f'wider than a block')
    rpb = max(1, _THREADS // tc)
    per_block = -(-v // _FILL_BLOCKS)    # rows a block at the fill
    rows = max(_ROWS_A_THREAD, -(-per_block // rpb)) * rpb
    return vec, rpb, rows, max(1, -(-v // rows))


@functools.lru_cache(maxsize=None)
def _tile_of(v: int, c: int, dtype, aligned: bool):
    """The tile as csrc/norm.cu takes it (7 ints: type, v, c and
    ``_plan``'s four), kept for the life of the process."""
    if v >= _MAX_ROWS:
        raise ValueError(f'masked_batch_norm: {v} rows, at most 2^24 - 1')
    return (ctypes.c_int * 7)(_DTYPES[dtype], v, c, *_plan(v, c, dtype,
                                                            aligned))


def _tile(x, *more):
    """The tile of a pass over x (and ``more``, of x's shape and type)."""
    ptr = x.data_ptr()
    for t in more:
        ptr |= t.data_ptr()
    return _tile_of(x.shape[0], x.shape[1], x.dtype, not ptr % 16)


def _check(x, *vectors) -> None:
    """Raise unless x is a contiguous (V, C) f32 / bf16 CUDA tensor and the
    vectors (C,) f32 CUDA tensors."""
    if x.dtype not in _DTYPES or x.dim() != 2:
        raise ValueError(f'masked_batch_norm: x must be (V, C) float32 or '
                         f'bfloat16, got {tuple(x.shape)} {x.dtype}')
    c = x.shape[1]
    for t in vectors:
        if t.dtype != torch.float32 or t.shape != (c,) or not t.is_cuda:
            raise ValueError('masked_batch_norm: scale, bias and the '
                             'running buffers must be (C,) float32 on the '
                             'card')
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError('masked_batch_norm: x must be a contiguous CUDA '
                         'tensor')


def _mask(mask, v: int):
    """The mask as the kernels read it: (v,) bool, contiguous."""
    if mask.dtype != torch.bool:
        mask = mask != 0
    if mask.shape != (v,) or not mask.is_cuda:
        raise ValueError('masked_batch_norm: the mask must be (V,) on the '
                         'card')
    return mask.contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(x, mask, scale, bias, run_mean, run_var, training, eps,
             momentum, relu):
    """(output, the statistics the backward reads: [mean, rstd, n] and the
    partials; None in eval), the running buffers moved in train mode."""
    count('bn.kernel.forward')
    _check(x, scale, bias, run_mean, run_var)
    tile = _tile(x)
    out = torch.empty_like(x)
    st = None
    if training:
        mask = _mask(mask, x.shape[0])
        st = torch.empty((tile[6] + 1) * (2 * x.shape[1] + 1),
                         dtype=torch.float32, device=x.device)
    rc = kernels.entry('norm', 'sg_bn_forward')(
        tile, x.data_ptr(), mask.data_ptr() if training else None,
        scale.data_ptr(), bias.data_ptr(), run_mean.data_ptr(),
        run_var.data_ptr(), eps, momentum,
        (_RELU if relu else 0) | (0 if training else _EVAL),
        st.data_ptr() if training else None, out.data_ptr(),
        kernels.stream(x.device))
    kernels.check(rc, 'masked_batch_norm')
    masked_batch_norm.launches += 3 if training else 1
    return out, (mask, st)


class _BatchNorm(torch.autograd.Function):
    """Masked batch norm (+ ReLU) whose backward is the kernels too; saves
    x, the mask and the statistics (eval: x and the running buffers)."""

    @staticmethod
    def forward(ctx, x, mask, scale, bias, run_mean, run_var, training,
                eps, momentum, relu):
        out, (mask, st) = _forward(x, mask, scale, bias, run_mean, run_var,
                                   training, eps, momentum, relu)
        ctx.eps = eps
        ctx.flags = (_RELU if relu else 0) | (0 if training else _EVAL)
        if training:
            ctx.save_for_backward(x, scale, bias, mask, st)
        else:
            ctx.save_for_backward(x, scale, bias, run_mean, run_var)
        return out

    @staticmethod
    def backward(ctx, dy):
        count('bn.kernel.backward')
        x, scale, bias, *saved = ctx.saved_tensors
        evaluate = ctx.flags & _EVAL
        mask, st = (None, None) if evaluate else saved
        run_mean, run_var = saved if evaluate else (None, None)
        need_x, _, need_s, need_b = ctx.needs_input_grad[:4]
        params = need_s or need_b
        dy = dy.contiguous()
        if dy.shape != x.shape or dy.dtype != x.dtype:
            raise ValueError('masked_batch_norm: the gradient must be of '
                             'the output\'s shape and type')
        tile = _tile(x, dy)
        c = x.shape[1]
        reduce = params or not evaluate
        scratch = torch.empty((4 + 2 * tile[6]) * c, dtype=torch.float32,
                              device=x.device) if reduce else None
        dx = torch.empty_like(x) if need_x else None
        rc = kernels.entry('norm', 'sg_bn_backward')(
            tile, x.data_ptr(), dy.data_ptr(), _ptr(mask), scale.data_ptr(),
            bias.data_ptr(), _ptr(run_mean), _ptr(run_var), _ptr(st),
            ctx.eps, ctx.flags | (_PARAMS if params else 0), _ptr(scratch),
            _ptr(dx), kernels.stream(x.device))
        kernels.check(rc, 'masked_batch_norm backward')
        masked_batch_norm.launches += 2 * reduce + bool(need_x)
        return (dx, None, scratch[:c] if need_s else None,
                scratch[c:2 * c] if need_b else None,
                None, None, None, None, None, None)


def masked_batch_norm(x, mask, scale, bias, run_mean, run_var,
                      training: bool, eps: float, momentum: float,
                      relu: bool = False) -> torch.Tensor:
    """Masked batch norm, then the ReLU where ``relu``: x (V, C) bf16 or
    f32, mask (V,) bool (train mode), scale / bias / running buffers (C,)
    f32.  On a CPU tensor ``batch_norm_plain``; on a CUDA tensor the
    kernels (``.launches`` counts them)."""
    if not x.is_cuda:
        return batch_norm_plain(x, mask, scale, bias, run_mean, run_var,
                                training, eps, momentum, relu)
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _BatchNorm.apply(x, mask, scale, bias, run_mean, run_var,
                                training, eps, momentum, relu)
    return _forward(x, mask, scale, bias, run_mean, run_var, training, eps,
                    momentum, relu)[0]


masked_batch_norm.launches = 0
