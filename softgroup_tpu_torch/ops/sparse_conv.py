"""Sparse 3-D convolution ops (counterpart of
``softgroup_tpu/ops/sparse_conv.py``).

``subm_conv`` / ``down_conv`` run on the rulebook gather-GEMM kernel K1
(``conv_kernel.rulebook_conv``).  ``inverse_conv`` and ``linear`` are plain
products, as the reference leaves them to XLA outside Pallas.  The compute
type is the features' type; products are summed in f32 and rounded once to
that type (the reference's bf16 policy).

The three convs are ``torch.autograd.Function``s with the reference's
scatter-free backwards (``_subm_vjp``, ``_down_vjp``, ``_inv_vjp``): every
feature gradient is another gather conv on K1, every weight gradient is the
K5 kernel (``conv_kernel.rulebook_conv_dw``).  The cotangent is cast to the
features' type first, and weight gradients are f32 sums returned in the
weight's type.

A submanifold conv runs on a row order of its level (``hit_orders``): K1
reads the rulebook's columns grouped by hit mask, so that a 64-row tile's
rows share their taps, and writes each row back in place.  The order
changes no sum: a row adds its hit taps in tap order either way.
"""

from __future__ import annotations

import torch

from ..util.trace import count, span
from .conv_kernel import rulebook_conv, rulebook_conv_dw


# a row order's sort key: the hit mask of <= 27 taps, the level above it
_TAP_BITS = 27
_MAX_LEVELS = 16


def hit_orders(rulebooks) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The row order of each (K, V) rulebook of ``rulebooks`` (the levels
    of a pyramid, on one device, K <= 27 taps alike): (rows (V,) int32, the
    grouped rulebook ``rules[:, rows]`` (K, V) int32, a column slice of one
    table for all levels).  Rows are sorted stably by their hit mask (bit k
    set where ``rules[k, v] >= 0``): rows of one mask keep the level's
    order, and the rows that hit nothing (a capacity's padding) come first,
    together.  One sort for all levels (each key carries its level above
    the mask), on the device, without a host synchronise."""
    rulebooks = list(rulebooks)
    k = rulebooks[0].shape[0]
    if len(rulebooks) > _MAX_LEVELS or k > _TAP_BITS or any(
            r.shape[0] != k for r in rulebooks):
        raise ValueError(f'hit_orders: at most {_MAX_LEVELS} rulebooks of '
                         f'one number of taps, at most {_TAP_BITS}')
    count('conv.row_order', len(rulebooks))
    with span('conv.row_order'):
        table = torch.cat([r.to(torch.int32) for r in rulebooks], 1)
        bits = 1 << torch.arange(k, dtype=torch.int32, device=table.device)
        keys = torch.where(table >= 0, bits[:, None], 0).sum(
            0, dtype=torch.int32)
        bases, base = [], 0
        for lvl, r in enumerate(rulebooks):
            bases.append(base)
            if lvl:
                keys[base:base + r.shape[1]] |= lvl << _TAP_BITS
            base += r.shape[1]
        order = torch.sort(keys, stable=True).indices
        grouped = table.index_select(1, order)
        rows = order.to(torch.int32)
        out = []
        for base, r in zip(bases, rulebooks):
            at = slice(base, base + r.shape[1])
            if base:
                rows[at] -= base
            out.append((rows[at], grouped[:, at]))
        return out


class _SubmConv(torch.autograd.Function):
    """Submanifold conv.  Backward: the transpose of tap k is tap K-1-k on
    the same rulebook (the in and out voxel sets coincide), so the feature
    gradient is the conv with flipped, transposed weights.  Both K1 calls
    run on the row order (``rows``, ``grouped``): flipping the taps mirrors
    every row's mask alike, so the order groups them too.  The weight
    gradient (K5) reads the natural ``rules``."""

    @staticmethod
    def forward(ctx, feats, weight, rules, rows, grouped):
        ctx.save_for_backward(feats, weight, rules, rows, grouped)
        return rulebook_conv(feats, weight, grouped, rows=rows)

    @staticmethod
    def backward(ctx, g):
        feats, weight, rules, rows, grouped = ctx.saved_tensors
        g = g.to(feats.dtype)
        g_feats = g_weight = None
        if ctx.needs_input_grad[0]:
            g_feats = rulebook_conv(g, weight.transpose(1, 2).flip(0),
                                    grouped, rows=rows)
        if ctx.needs_input_grad[1]:
            g_weight = rulebook_conv_dw(feats, g, rules).to(weight.dtype)
        return g_feats, g_weight, None, None, None


def _parents_from_down_rules(down_rules: torch.Tensor, v_fine: int):
    """(parent_idx, child_tap) of every fine voxel from a (8, V_coarse)
    down rulebook (V_coarse / tap 0 for a voxel without a parent), the
    reference's ``_down_bwd`` reconstruction."""
    k, v_c = down_rules.shape
    dev = down_rules.device
    flat = torch.where(down_rules >= 0, down_rules, v_fine).reshape(-1).long()
    cols = torch.arange(v_c, dtype=torch.int32, device=dev).repeat(k)
    taps = torch.arange(k, dtype=torch.int32,
                        device=dev).repeat_interleave(v_c)
    parent = torch.full((v_fine + 1,), v_c, dtype=torch.int32, device=dev)
    tap = torch.zeros((v_fine + 1,), dtype=torch.int32, device=dev)
    parent[flat] = cols
    tap[flat] = taps
    return parent[:v_fine], tap[:v_fine]


class _DownConv(torch.autograd.Function):
    """k2s2 down conv.  Backward: each fine voxel has exactly one (parent,
    tap), so the feature gradient is the paired inverse conv of the
    cotangent with transposed weights (a gather, no scatter-add)."""

    @staticmethod
    def forward(ctx, feats, weight, rules):
        ctx.save_for_backward(feats, weight, rules)
        return rulebook_conv(feats, weight, rules)

    @staticmethod
    def backward(ctx, g):
        feats, weight, rules = ctx.saved_tensors
        g = g.to(feats.dtype)
        g_feats = g_weight = None
        if ctx.needs_input_grad[0]:
            parent, tap = _parents_from_down_rules(rules, feats.shape[0])
            g_feats = inverse_product(g, weight.transpose(1, 2), parent, tap)
        if ctx.needs_input_grad[1]:
            g_weight = rulebook_conv_dw(feats, g, rules).to(weight.dtype)
        return g_feats, g_weight, None


class _InverseConv(torch.autograd.Function):
    """Inverse (up) conv with the paired down rulebook.  Backward: the
    feature gradient is the paired down conv of the fine cotangent with
    transposed weights (K1); the weight gradient
    ``dW[t] = sum_p feats[p]^T g[down_rules[t, p]]`` is K5 with the roles
    of the two operands swapped (``rulebook_conv_dw(g, feats, down_rules)``
    transposed): the reference's one (V, 8 Cin) x (V, Cout) product without
    its (V, 8 Cin) one-hot block matrix."""

    @staticmethod
    def forward(ctx, feats, weight, parent_idx, child_tap, down_rules):
        ctx.save_for_backward(feats, weight, down_rules)
        return inverse_product(feats, weight, parent_idx, child_tap)

    @staticmethod
    def backward(ctx, g):
        feats, weight, down_rules = ctx.saved_tensors
        g = g.to(feats.dtype)
        g_feats = g_weight = None
        if ctx.needs_input_grad[0]:
            g_feats = rulebook_conv(g, weight.transpose(1, 2), down_rules)
        if ctx.needs_input_grad[1]:
            g_weight = rulebook_conv_dw(g, feats, down_rules).transpose(
                1, 2).to(weight.dtype)
        return g_feats, g_weight, None, None, None


def subm_conv(feats: torch.Tensor, weight: torch.Tensor,
              rules: torch.Tensor, rows: torch.Tensor,
              grouped: torch.Tensor) -> torch.Tensor:
    """Submanifold k=3 conv: feats (V, Cin), weight (27, Cin, Cout),
    rules (27, V) -> (V, Cout), K1 on the level's row order ``rows``,
    ``grouped`` (``hit_orders``)."""
    return _SubmConv.apply(feats, weight, rules, rows, grouped)


def down_conv(feats: torch.Tensor, weight: torch.Tensor,
              down_rules: torch.Tensor) -> torch.Tensor:
    """Strided k=2 s=2 conv: feats (V_fine, Cin), weight (8, Cin, Cout),
    down_rules (8, V_coarse) -> (V_coarse, Cout)."""
    return _DownConv.apply(feats, weight, down_rules)


def inverse_product(feats: torch.Tensor, weight: torch.Tensor,
                    parent_idx: torch.Tensor,
                    child_tap: torch.Tensor) -> torch.Tensor:
    """``out[v] = feats[parent[v]] @ W[tap[v]]`` (0 for a parent out of
    range): one (V, Cin) x (Cin, 8*Cout) product of the parents' rows, then
    a pick of each row's tap block (the reference's one-hot block matmul,
    ``_inverse_fwd``, reordered)."""
    k, cin, cout = weight.shape
    v = feats.shape[0]
    padded = torch.cat([feats.float(), feats.new_zeros((1, cin),
                                                       dtype=torch.float32)])
    pf = padded[torch.where(parent_idx < 0, v, parent_idx).long()
                .clamp(max=v)]
    w = weight.to(feats.dtype).float().permute(1, 0, 2).reshape(cin, k * cout)
    y = (pf @ w).reshape(-1, k, cout)
    tap = child_tap.long().clamp(0, k - 1)
    out = torch.gather(y, 1, tap[:, None, None].expand(-1, 1, cout))[:, 0]
    return out.to(feats.dtype)


def inverse_conv(feats: torch.Tensor, weight: torch.Tensor,
                 parent_idx: torch.Tensor, child_tap: torch.Tensor,
                 down_rules: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse (up) k=2 conv: feats (V_coarse, Cin), weight (8, Cin, Cout),
    parent_idx (V_fine,) (V_coarse for none), child_tap (V_fine,) ->
    (V_fine, Cout).  With the paired (8, V_coarse) ``down_rules`` the
    backward runs on K1 and K5; without them (the keyed inference levels)
    autograd differentiates the plain product."""
    if down_rules is None:
        return inverse_product(feats, weight, parent_idx, child_tap)
    return _InverseConv.apply(feats, weight, parent_idx, child_tap,
                              down_rules)


def linear(feats: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """(V, Cin) x (Cin, Cout) [+ bias], f32 sum, rounded to feats' type."""
    out = feats.float() @ weight.to(feats.dtype).float()
    if bias is not None:
        out = out + bias.float()
    return out.to(feats.dtype)
