"""K2 row gather ``out[i] = src[clamp(idx[i], 0, len(src) - 1)]``, K6
sorted segment sum, and the differentiable gather built on both.

K2 replaces ``softgroup_tpu/ops/gather_kernel.py:_gather_kernel`` (driven
by ``monotone_row_gather`` / ``monotone_gather_f32``).  On the main path it
carries devoxelize (voxel features back to points), the grouping entry
gather and the cell-label gather, plus the proposal-entry gather of
``clusters_voxelization``, the ++ heads, ``exact_ball_query``'s candidate
gather and the backward's cotangent gather.  The copy moves raw bytes, so
it is exact for every dtype and needs no monotone indices.  It is bound by
bytes on the H100 and takes one of three routes by row bytes and alignment
(design note: ``csrc/gather.cu``): rows of 1-8 bytes (the int32 cell
labels) go 16 output bytes to a thread; rows a multiple of 16 bytes one
16-byte vector to a thread; every other row (12-, 38-, 72-, 76-, 92-,
140-byte rows) takes the word route, where a block stages 8 or 16 KB of
output in shared memory from its rows' indices, read once, and writes it
with 16-byte stores.  Index math is 32-bit and the indices are read as
int32 or int64 as given.  The wrapper casts nothing, builds no view and
looks its C entry point up once; an empty index gives an empty output
without a launch.

K6 ``sorted_segment_sum`` replaces ``gather_kernel.py:_segsum_kernel``
(driven by ``monotone_segment_sum``): the backward of ``gather_rows``, the
gather of the training step (devoxelize, the proposal-entry gather, the
mask gather), as the reference's ``_devox_vjp`` / ``gather_rows_segsum_vjp``
backwards are.  Its kernels write every row of the output (the wrapper
allocates it without zeroing) and round the f32 sums once to ``out_dtype``,
so the backward gets its gradient in the source's dtype without a cast
pass.  Design note: ``csrc/gather.cu``.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it takes the plain version below.
"""

from __future__ import annotations

import math

import torch

from . import kernels

_SEG_ROWS = 512   # K6's rows per chunk at most (fewer for rows over 80 bytes)
# values of a K6 chunk: a block holds one in its 227 KB of shared memory,
# beside its segs and partials
_SEG_MAX_CHUNK_BYTES = 200 * 1024
_SEG_TYPES = (torch.float32, torch.bfloat16)
_INDEX_TYPES = (torch.int32, torch.int64)   # K2 reads these as they are
_INT_MAX = 2 ** 31 - 1


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (clamped indices, as JAX gathers clamp)."""
    return src[idx.long().clamp(0, src.shape[0] - 1)]


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``src`` (any dtype, any trailing shape) at the 1-D
    integer ``idx``."""
    if src.device.type == 'cpu':
        return row_gather_plain(src, idx)
    n_src, tail = src.shape[0], src.shape[1:]
    if n_src == 0:
        raise ValueError('row_gather: empty source')
    if idx.dtype not in _INDEX_TYPES:
        idx = idx.to(torch.int32)
    if not src.is_contiguous():
        src = src.contiguous()
    if not idx.is_contiguous():
        idx = idx.contiguous()
    if src.device.type != 'cuda' or idx.device != src.device:
        raise ValueError(f'row_gather: tensors must share one CUDA device, '
                         f'got {src.device} and {idx.device}')
    if idx.dim() != 1:
        raise ValueError('row_gather: idx must be 1-D')
    n_out = idx.shape[0]
    row_bytes = math.prod(tail) * src.element_size()
    if n_out * row_bytes > _INT_MAX or n_src > _INT_MAX:
        raise ValueError('row_gather: over 2 GiB of output or 2^31 source '
                         'rows: the kernel indexes in 32 bits')
    out = torch.empty((n_out,) + tail, dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    rc = kernels.entry('gather', 'sg_row_gather')(
        src.data_ptr(), idx.data_ptr(), idx.dtype == torch.int64, n_src,
        n_out, row_bytes, out.data_ptr(), kernels.stream(src.device))
    kernels.check(rc, 'row_gather')
    row_gather.launches += 1
    return out


row_gather.launches = 0


def sorted_segment_sum_plain(values: torch.Tensor, seg: torch.Tensor,
                             num_segments: int,
                             out_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Plain version of K6: ``index_add_`` in f32 over the in-range rows
    (sequential in row order on the CPU), then one cast to ``out_dtype``."""
    ok = (seg >= 0) & (seg < num_segments)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=torch.float32, device=values.device)
    out.index_add_(0, seg[ok].long(), values[ok].float())
    return out.to(out_dtype)


def seg_rows_per_chunk(row_bytes: int) -> int:
    """K6's rows per chunk (one chunk a block, staged in shared memory):
    ``_SEG_ROWS`` for narrow rows, fewer (a multiple of 32, at least 32)
    for wider rows, so a chunk stays within 40 KB."""
    return min(_SEG_ROWS, max(32, 40960 // row_bytes // 32 * 32))


def sorted_segment_sum(values: torch.Tensor, seg: torch.Tensor,
                       num_segments: int,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """K6: values (N, C) bf16 or f32, seg (N,) NON-DECREASING ->
    (num_segments, C) of ``out_dtype`` (f32, or the values' dtype), summed
    in f32 and rounded once; rows with seg outside [0, num_segments)
    drop."""
    if out_dtype not in (torch.float32, values.dtype):
        raise ValueError(f'sorted_segment_sum: out must be float32 or the '
                         f'values\' {values.dtype}, got {out_dtype}')
    if values.device.type == 'cpu':
        return sorted_segment_sum_plain(values, seg, num_segments, out_dtype)
    if values.dtype not in _SEG_TYPES:
        raise ValueError(f'sorted_segment_sum: values must be float32 or '
                         f'bfloat16, got {values.dtype}')
    if values.dim() != 2 or seg.shape != values.shape[:1]:
        raise ValueError('sorted_segment_sum: values (N, C), seg (N,)')
    values = values.contiguous()
    seg = seg.to(torch.int32).contiguous()
    kernels.require_cuda('sorted_segment_sum', values, seg)
    n, c = values.shape
    row_bytes = c * values.element_size()
    rows = seg_rows_per_chunk(row_bytes)
    if rows * row_bytes > _SEG_MAX_CHUNK_BYTES:
        raise ValueError(f'sorted_segment_sum: rows of {row_bytes} bytes do '
                         f'not fit a chunk in shared memory')
    # every row is written by the kernels: no zeroing
    out = torch.empty((num_segments, c), dtype=out_dtype,
                      device=values.device)
    if out.numel() == 0:
        return out
    # per chunk: the partial sums of a segment crossing its first and its
    # last row
    parts = torch.empty((2, max(1, -(-n // rows)), c), dtype=torch.float32,
                        device=values.device)
    rc = kernels.entry('gather', 'sg_segment_sum')(
        values.data_ptr(), seg.data_ptr(), n, num_segments, c,
        int(values.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), rows, out.data_ptr(),
        parts[0].data_ptr(), parts[1].data_ptr(),
        kernels.stream(values.device))
    kernels.check(rc, 'sorted_segment_sum')
    sorted_segment_sum.launches += 1
    return out


sorted_segment_sum.launches = 0


class _GatherRows(torch.autograd.Function):
    """``src[clamp(idx)]`` on K2; backward: the segment sum of the output
    cotangent over the clamped index on K6, after a stable sort of the
    index and a K2 gather of the cotangent rows unless the caller
    guarantees a non-decreasing index.  K6 writes the gradient in ``src``'s
    dtype where it can (f32 or bf16: one rounding of the f32 sum, as the
    reference's cast after its f32 sum), so no cast pass follows."""

    @staticmethod
    def forward(ctx, src, idx, sorted_idx):
        ctx.n_src, ctx.tail, ctx.dtype = src.shape[0], src.shape[1:], \
            src.dtype
        ctx.sorted_idx = sorted_idx
        ctx.save_for_backward(idx)
        return row_gather(src, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        seg = idx.to(torch.int32).clamp(0, ctx.n_src - 1)
        if not ctx.sorted_idx:
            seg, order = torch.sort(seg, stable=True)
            g = row_gather(g, order)
        g = g.reshape(g.shape[0], -1)
        gv = sorted_segment_sum(g, seg, ctx.n_src, out_dtype=(
            ctx.dtype if ctx.dtype in _SEG_TYPES else torch.float32))
        return gv.reshape((ctx.n_src,) + ctx.tail).to(ctx.dtype), None, None


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                sorted_idx: bool = False) -> torch.Tensor:
    """Differentiable ``src[clamp(idx, 0, len(src) - 1)]`` (float ``src``
    of any trailing shape).  ``sorted_idx``: the caller guarantees that the
    clamped ``idx`` is non-decreasing, so the backward skips the sort.  The
    gradient is summed in f32 and returned in ``src``'s dtype."""
    if not (torch.is_grad_enabled() and src.requires_grad):
        return row_gather(src, idx)
    return _GatherRows.apply(src, idx, sorted_idx)
