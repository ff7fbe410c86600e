"""Segment reductions over flat ``segment_ids`` (padding rows point at a
dustbin segment ``num_segments``) — counterpart of
``softgroup_tpu/ops/segment.py`` on torch scatter ops.  Sums are f32 scatter
adds, so their order (and last bits) differ from the reference's."""

from __future__ import annotations

import torch


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = values.new_zeros((num_segments + 1,) + tuple(values.shape[1:]))
    out.index_add_(0, segment_ids.long().clamp(0, num_segments), values)
    return out[:num_segments]


def segment_count(segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    return torch.bincount(segment_ids.long().clamp(0, num_segments),
                          minlength=num_segments + 1)[:num_segments]


def _bcast(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape((-1,) + (1,) * (ndim - 1))


def segment_mean(values: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean per segment (empty -> 0), summed in f32 and returned in the
    values' dtype."""
    total = segment_sum(values.float(), segment_ids, num_segments)
    count = segment_count(segment_ids, num_segments).clamp(min=1)
    return (total / _bcast(count, total.ndim).float()).to(values.dtype)


def segment_mean_fused(values: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """segment_mean with the count carried as an extra ones column, as the
    reference computes it (one scatter pass)."""
    aug = torch.cat([values, values.new_ones((values.shape[0], 1))], dim=1)
    out = segment_sum(aug, segment_ids, num_segments)
    return out[:, :-1] / out[:, -1:].clamp(min=1)


def _segment_reduce(values, segment_ids, num_segments, reduce):
    ids = segment_ids.long().clamp(0, num_segments)
    out = values.new_zeros((num_segments + 1,) + tuple(values.shape[1:]))
    idx = _bcast(ids, values.ndim).expand_as(values)
    out = out.scatter_reduce(0, idx, values, reduce=reduce,
                             include_self=False)[:num_segments]
    nonempty = _bcast(segment_count(segment_ids, num_segments) > 0, out.ndim)
    return torch.where(nonempty, out, torch.zeros_like(out))


def segment_min(values, segment_ids, num_segments):
    """Min per segment (empty -> 0).  Exact: the reference's sorted sparse-
    table ``sorted_segment_minmax`` computes the same values."""
    return _segment_reduce(values, segment_ids, num_segments, 'amin')


def segment_max(values, segment_ids, num_segments):
    """Max per segment (empty -> 0)."""
    return _segment_reduce(values, segment_ids, num_segments, 'amax')
