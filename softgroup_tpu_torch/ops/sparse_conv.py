"""Sparse 3-D convolution ops (counterpart of
``softgroup_tpu/ops/sparse_conv.py``, inference path).

``subm_conv`` / ``down_conv`` run on the rulebook gather-GEMM kernel K1
(``conv_kernel.rulebook_conv``).  ``inverse_conv`` and ``linear`` are plain
products, as the reference leaves them to XLA outside Pallas.  The compute
type is the features' type; products are summed in f32 and rounded once to
that type (the reference's bf16 policy).
"""

from __future__ import annotations

import torch

from .conv_kernel import rulebook_conv


def subm_conv(feats: torch.Tensor, weight: torch.Tensor,
              rules: torch.Tensor) -> torch.Tensor:
    """Submanifold k=3 conv: feats (V, Cin), weight (27, Cin, Cout),
    rules (27, V) -> (V, Cout)."""
    return rulebook_conv(feats, weight, rules)


def down_conv(feats: torch.Tensor, weight: torch.Tensor,
              down_rules: torch.Tensor) -> torch.Tensor:
    """Strided k=2 s=2 conv: feats (V_fine, Cin), weight (8, Cin, Cout),
    down_rules (8, V_coarse) -> (V_coarse, Cout)."""
    return rulebook_conv(feats, weight, down_rules)


def inverse_conv(feats: torch.Tensor, weight: torch.Tensor,
                 parent_idx: torch.Tensor,
                 child_tap: torch.Tensor) -> torch.Tensor:
    """Inverse (up) k=2 conv: feats (V_coarse, Cin), weight (8, Cin, Cout),
    parent_idx (V_fine,) (V_coarse for none), child_tap (V_fine,) ->
    (V_fine, Cout): ``out[v] = feats[parent[v]] @ W[tap[v]]``.

    One (V, Cin) x (Cin, 8*Cout) product of the parents' rows, then a pick
    of each row's tap block (the reference's one-hot block matmul,
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


def linear(feats: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """(V, Cin) x (Cin, Cout) [+ bias], f32 sum, rounded to feats' type."""
    out = feats.float() @ weight.to(feats.dtype).float()
    if bias is not None:
        out = out + bias.float()
    return out.to(feats.dtype)
