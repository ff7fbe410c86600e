"""K1, K4 and K5: sparse 3-D convolution as a gather-GEMM on Hopper.

* K1 ``rulebook_conv`` — ``out[v] = sum_k feats[rules[k, v]] @ W[k]`` over
  an explicit (K <= 32, V_out) rulebook (-1 adds zero).  Replaces
  ``softgroup_tpu/ops/conv_kernel.py:_conv_kernel`` (driven by
  ``_windowed_conv_core``): every backbone submanifold and k2s2 down conv,
  and their feature gradients.  On the H100 it is bound by bytes (the
  rulebook is about half of them at 32 channels) and held back by latency:
  a block's gathers wait on its rules, its MMAs on its gathers.  The bf16
  kernel reads the tile's whole rule slab up front, walks a list of steps
  (32 channels of (hit tap, channel chunk) pieces) through a 3-stage
  ring of ``cp.async`` gathers and ``mma.sync`` tensor-core products, and
  stores 16-byte vectors from registers; deep levels cut each tile's step
  list over ``split`` blocks.  With a row order (``rows``) the rulebook's
  columns come grouped by hit mask and tile row i is written to output row
  ``rows[i]``: every submanifold conv (``sparse_conv.hit_orders``).
  f32 (the small card-vs-CPU checks) stays on CUDA-core FMA.
* K4 ``keyed_conv`` — the same conv with neighbours resolved in the kernel
  from sorted linear keys ``((b*D + x)*D + y)*D + z`` on the proposal grid
  (bounds-tested like ``conv_kernel.py:848-871``).  Replaces
  ``conv_kernel.py:_keyed_kernel`` (driven by ``keyed_windowed_conv``):
  the tiny refinement U-Net.  bf16 runs K1's kernel, whose prologue here
  fills the tile's rule slab by searches of the key table advanced in
  lockstep (a subm search spans only the rows within its key offset), and
  cuts a tile's step list like K1.
* K5 ``rulebook_conv_dw`` — the weight gradient
  ``dW[k] = sum_v feats[rules[k, v]]^T g[v]`` (f32) of every rulebook conv
  of the training step.  Replaces ``conv_kernel.py:_dw_kernel`` (driven by
  ``windowed_conv_dw``, dispatched by ``sparse_conv._dw``).  bf16: a block
  takes a (Cin, Cout) tile, a group of taps (one on the deep levels) and
  every split-th 32-row step, through a ``cp.async`` ring (rules four steps
  ahead, rows two) into ``mma.sync``; the g rows of a step are read once
  for the group; each block writes an f32 slab, summed in slab order
  (deterministic).  f32 stays on CUDA-core FMA, one tap a block.

Kernel source and design note: ``csrc/conv.cu``.  The TPU's windows,
overflow corrections, bf16x3 split and transposed accumulator have no
counterpart: the kernel reads the rules (or keys) directly.

Both take bf16 or f32 features; weights are cast to the features' type,
the sum is f32 and the output is rounded once to the features' type.  On
a CUDA tensor the wrappers launch the kernel or raise; on a CPU tensor they
take the plain versions below.
"""

from __future__ import annotations

import itertools

import torch

from ..util.trace import count
from . import kernels

INT_MAX = 2 ** 31 - 1
# tap order: (dx+1)*9 + (dy+1)*3 + (dz+1) for subm, dx*4 + dy*2 + dz for down
SUBM_OFFS = tuple(itertools.product((-1, 0, 1), repeat=3))
DOWN_OFFS = tuple(itertools.product((0, 1), repeat=3))

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/conv.cu tiles: 64 output rows x 32 (Cout <= 32) or 64 channels
_ROWS_PER_BLOCK = 64
_MAX_TAPS = 32   # K1's hit-tap mask is one 32-bit word
# a grid with fewer blocks than this (2 per SM of an H100) spreads its taps
# over several blocks per tile (f32 partial slabs, summed by a second kernel)
_FILL_BLOCKS = 264
# the same for the bf16 K1, whose blocks cut a tile's step list: 4 per SM
# (the deep levels' times at 264, 528 and 1056 on an H100 favour 528)
_K1_FILL_BLOCKS = 528
# K4 runs K1's kernel and K1's step-list split for a smaller grid: its
# capacity rows are mostly padding, and a split down conv's f32 slabs cost
# more than the split gains (PERF.md, PR 4)
_K4_FILL_BLOCKS = 256
# K5, bf16: a block takes a group of taps (its f32 sums stay in registers,
# G x the tile / 128 a thread; the g rows of a step are read once for the
# group) and every split-th 32-row step of the rulebook, split chosen for a
# launch of about _DW_FILL_BLOCKS blocks (one wave of 3 an SM), or
# _DW_WIDE_FILL_BLOCKS for a group on a 64 x 64 tile (three waves of 2 an
# SM); the grid sizes of the H100 sweep in PERF.md, PR 4.  Each block writes
# an f32 slab, summed in slab order.  A rulebook of at most _DW_FEW_STEPS
# steps (the deep levels) takes one tap a block, four blocks an SM.
_DW_STEP_ROWS = 32
_DW_GROUP = 3
_DW_FEW_STEPS = 1024
_DW_FILL_BLOCKS = 396
_DW_WIDE_FILL_BLOCKS = 792
# K5, f32 (CUDA-core FMA, one tap a block): 64-row chunks, ~15 blocks an SM
_DW_FMA_ROWS = 64
_DW_FMA_FILL_BLOCKS = 2048


def _split(v_out: int, cout: int, parts: int, fill: int) -> int:
    """Blocks a tile's work is cut over so that the grid has about
    ``fill`` blocks; ``parts``: the most it can be cut into."""
    cols = 32 if cout <= 32 else 64
    blocks = -(-v_out // _ROWS_PER_BLOCK) * -(-cout // cols)
    return 1 if blocks >= fill else min(parts, -(-fill // max(blocks, 1)))


def _conv_split(k: int, cin: int, v_out: int, cout: int,
                dtype: torch.dtype, fill: int | None = None) -> int:
    """Blocks each 64-row tile of K1 or K4 is cut over.  bf16 cuts the
    tile's step list (32 channels of (tap, 16- or 32-channel chunk) pieces,
    csrc/conv.cu launch_k1_cols) for a grid of about ``fill`` blocks
    (_K1_FILL_BLOCKS by default); f32 cuts the tap range for about
    _FILL_BLOCKS."""
    if dtype == torch.bfloat16:
        pw = 16 if cin <= 16 else 32
        return _split(v_out, cout, -(-k * -(-cin // pw) // (32 // pw)),
                      _K1_FILL_BLOCKS if fill is None else fill)
    return _split(v_out, cout, k, _FILL_BLOCKS)


def _partial(split: int, v_out: int, cout: int, like: torch.Tensor):
    """The f32 (split, v_out, cout) slabs a split launch sums, or None."""
    return torch.empty((split, v_out, cout), dtype=torch.float32,
                       device=like.device) if split > 1 else None


def rulebook_conv_plain(feats: torch.Tensor, weight: torch.Tensor,
                        rules: torch.Tensor,
                        rows: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K1 (the reference's ``_conv_xla``): per-tap gather
    of a zero-padded feature matrix, f32 product, f32 sum; with ``rows``,
    column v of the rules is output row ``rows[v]``."""
    v = feats.shape[0]
    w = weight.to(feats.dtype).float()
    padded = torch.cat([feats.float(),
                        feats.new_zeros((1, feats.shape[1]),
                                        dtype=torch.float32)])
    acc = feats.new_zeros((rules.shape[1], w.shape[2]), dtype=torch.float32)
    for k in range(rules.shape[0]):
        idx = torch.where(rules[k] < 0, v, rules[k]).long()
        acc += padded[idx] @ w[k]
    out = acc.to(feats.dtype)
    if rows is None:
        return out
    return torch.empty_like(out).index_copy_(0, rows.long(), out)


def _prep(what, feats, weight):
    if feats.dtype not in _DTYPES:
        raise ValueError(f'{what}: feats must be float32 or bfloat16, '
                         f'got {feats.dtype}')
    feats = feats.contiguous()
    weight = weight.to(feats.dtype).contiguous()
    if weight.shape[1] != feats.shape[1]:
        raise ValueError(f'{what}: weight {tuple(weight.shape)} does not '
                         f'match feats {tuple(feats.shape)}')
    return feats, weight


def rulebook_conv(feats: torch.Tensor, weight: torch.Tensor,
                  rules: torch.Tensor, *,
                  rows: torch.Tensor | None = None) -> torch.Tensor:
    """K1: feats (V_in, Cin), weight (K, Cin, Cout), rules (K, V_out) int
    -> (V_out, Cout) in feats' dtype.  ``rows`` (V_out,) int32, a row
    order (``sparse_conv.hit_orders``): column v of ``rules`` is output row
    ``rows[v]``, so a rulebook grouped by hit mask gives the natural
    output."""
    if rows is not None:
        count('conv.k1_grouped')
    if feats.device.type == 'cpu':
        return rulebook_conv_plain(feats, weight, rules, rows)
    feats, weight = _prep('rulebook_conv', feats, weight)
    rules = rules.to(torch.int32)
    if rules.stride(-1) != 1:   # a column slice of a wider table is fine
        rules = rules.contiguous()
    kernels.require_cuda('rulebook_conv', feats, weight)
    if rules.device != feats.device:
        raise ValueError('rulebook_conv: rules on another device')
    if weight.shape[0] != rules.shape[0]:
        raise ValueError('rulebook_conv: weight taps != rulebook taps')
    k, cin, cout = weight.shape
    if not 1 <= k <= _MAX_TAPS:
        raise ValueError(f'rulebook_conv: 1 to {_MAX_TAPS} taps, got {k}')
    v_out = rules.shape[1]
    if rows is not None and (rows.dtype != torch.int32
                             or rows.shape != (v_out,)
                             or not rows.is_contiguous()
                             or rows.get_device() != feats.get_device()):
        raise ValueError('rulebook_conv: rows must be (V_out,) contiguous '
                         'int32 on the features\' device')
    out = torch.empty((v_out, cout), dtype=feats.dtype, device=feats.device)
    split = _conv_split(k, cin, v_out, cout, feats.dtype)
    partial = _partial(split, v_out, cout, feats)
    rc = kernels.entry('conv', 'sg_rulebook_conv')(
        feats.data_ptr(), weight.data_ptr(), rules.data_ptr(),
        rules.stride(0), None if rows is None else rows.data_ptr(), k,
        v_out, cin, cout, out.data_ptr(), _DTYPES[feats.dtype], split,
        partial.data_ptr() if split > 1 else None,
        kernels.stream(feats.device))
    kernels.check(rc, 'rulebook_conv')
    rulebook_conv.launches += 1
    rulebook_conv.grouped_launches += rows is not None
    return out


rulebook_conv.launches = 0
rulebook_conv.grouped_launches = 0   # of them on a row order


def rules_from_keys(out_keys: torch.Tensor, in_keys: torch.Tensor, d: int,
                    strided: bool) -> torch.Tensor:
    """(K, V_out) int32 rulebook by key lookup — the reference's
    ``conv_kernel._rules_from_keys``.  ``d`` is the output grid's D (for
    ``strided`` the coarse D; the fine grid is 2D)."""
    ok = (out_keys >= 0) & (out_keys != INT_MAX)
    key = torch.where(ok, out_keys, -1).to(torch.int32)
    d2, d3 = d * d, d * d * d
    zc, yc = key % d, (key // d) % d
    xc, bc = (key // d2) % d, key // d3
    far = torch.full_like(key, 2 ** 30)
    qs = []
    df = 2 * d
    for dx, dy, dz in (DOWN_OFFS if strided else SUBM_OFFS):
        if strided:
            q = ((bc * df + 2 * xc + dx) * df + 2 * yc + dy) * df \
                + 2 * zc + dz
            t_ok = ok
        else:
            q = key + dx * d2 + dy * d + dz
            t_ok = (ok & (xc + dx >= 0) & (xc + dx < d) & (yc + dy >= 0)
                    & (yc + dy < d) & (zc + dz >= 0) & (zc + dz < d))
        qs.append(torch.where(t_ok, q, far))
    q = torch.stack(qs)                                   # (K, V_out)
    tab = torch.where(in_keys == INT_MAX, 2 ** 30 - 1,
                      in_keys).to(torch.int32).contiguous()
    v_in = tab.shape[0]
    pos = torch.searchsorted(tab, q.reshape(-1)).reshape(q.shape)
    pc = pos.clamp(0, v_in - 1)
    hit = (pos < v_in) & (tab[pc] == q)
    return torch.where(hit, pc, -1).to(torch.int32)


def keyed_conv_plain(feats, weight, out_keys, in_keys, d: int,
                     strided: bool) -> torch.Tensor:
    """Plain version of K4: explicit rulebook, then the plain K1."""
    return rulebook_conv_plain(
        feats, weight, rules_from_keys(out_keys, in_keys, d, strided))


def keyed_conv(feats: torch.Tensor, weight: torch.Tensor,
               out_keys: torch.Tensor, in_keys: torch.Tensor, d: int,
               strided: bool) -> torch.Tensor:
    """K4: conv over sorted key tables (INT_MAX padded).

    Submanifold (``strided=False``): out_keys == in_keys, weight (27, C, C'),
    ``d`` the grid's D.  k2s2 down (``strided=True``): out_keys on the
    coarse grid of D = ``d``, in_keys on the fine grid of 2D, weight
    (8, C, C').  Returns (len(out_keys), Cout) in feats' dtype."""
    if feats.device.type == 'cpu':
        return keyed_conv_plain(feats, weight, out_keys, in_keys, d, strided)
    feats, weight = _prep('keyed_conv', feats, weight)
    out_keys = out_keys.to(torch.int32).contiguous()
    in_keys = in_keys.to(torch.int32).contiguous()
    kernels.require_cuda('keyed_conv', feats, weight, out_keys, in_keys)
    if weight.shape[0] != (8 if strided else 27):
        raise ValueError('keyed_conv: weight taps do not match the conv')
    if in_keys.shape[0] != feats.shape[0]:
        raise ValueError('keyed_conv: one input key per feature row')
    k, cin, cout = weight.shape
    v_out = out_keys.shape[0]
    out = torch.empty((v_out, cout), dtype=feats.dtype, device=feats.device)
    split = _conv_split(k, cin, v_out, cout, feats.dtype, _K4_FILL_BLOCKS)
    partial = _partial(split, v_out, cout, feats)
    # one key table for both sides of a subm conv: its searches span a
    # window of rows, not the table
    same = int(out_keys.data_ptr() == in_keys.data_ptr())
    rc = kernels.entry('conv', 'sg_keyed_conv')(
        feats.data_ptr(), weight.data_ptr(), out_keys.data_ptr(),
        in_keys.data_ptr(), feats.shape[0], v_out, cin, cout, int(d),
        int(strided), same, out.data_ptr(), _DTYPES[feats.dtype], split,
        partial.data_ptr() if split > 1 else None,
        kernels.stream(feats.device))
    kernels.check(rc, 'keyed_conv')
    keyed_conv.launches += 1
    return out


keyed_conv.launches = 0


def rulebook_conv_dw_plain(feats: torch.Tensor, g: torch.Tensor,
                           rules: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 (the per-tap gather and product of the
    reference's ``xla_dw``): ``g`` cast to feats' dtype, f32 products and
    sums, (K, Cin, Cout) f32."""
    v = feats.shape[0]
    g = g.to(feats.dtype).float()
    padded = torch.cat([feats.float(),
                        feats.new_zeros((1, feats.shape[1]),
                                        dtype=torch.float32)])
    return torch.stack([
        padded[torch.where(rules[k] < 0, v, rules[k]).long()].T @ g
        for k in range(rules.shape[0])])


def rulebook_conv_dw(feats: torch.Tensor, g: torch.Tensor,
                     rules: torch.Tensor) -> torch.Tensor:
    """K5: feats (V_in, Cin), g (V_out, Cout), rules (K, V_out) int ->
    (K, Cin, Cout) f32, ``g`` cast to feats' dtype first."""
    if feats.device.type == 'cpu':
        return rulebook_conv_dw_plain(feats, g, rules)
    if feats.dtype not in _DTYPES:
        raise ValueError(f'rulebook_conv_dw: feats must be float32 or '
                         f'bfloat16, got {feats.dtype}')
    feats, g = feats.contiguous(), g.to(feats.dtype).contiguous()
    rules = rules.to(torch.int32).contiguous()
    kernels.require_cuda('rulebook_conv_dw', feats, g, rules)
    k, v_out = rules.shape
    if g.shape[0] != v_out:
        raise ValueError('rulebook_conv_dw: one g row per rulebook column')
    cin, cout = feats.shape[1], g.shape[1]
    bf16 = feats.dtype == torch.bfloat16
    if bf16:   # the kernel copies 16-byte row pieces: rows of 8k channels
        feats, g = _rows_of_8(feats), _rows_of_8(g)
    feats, g = _aligned(feats), _aligned(g)
    out = torch.empty((k, cin, cout), dtype=torch.float32,
                      device=feats.device)
    group, split = _dw_plan(k, v_out, cin, cout, bf16)
    partial = torch.empty((split, k, cin, cout) if split > 1 else (0,),
                          dtype=torch.float32, device=feats.device)
    rc = kernels.entry('conv', 'sg_conv_dw')(
        feats.data_ptr(), feats.shape[1], g.data_ptr(), g.shape[1],
        rules.data_ptr(), k, v_out, cin, cout, _DTYPES[feats.dtype], group,
        split, out.data_ptr(), partial.data_ptr(),
        kernels.stream(feats.device))
    kernels.check(rc, 'rulebook_conv_dw')
    rulebook_conv_dw.launches += 1
    return out


rulebook_conv_dw.launches = 0


def _dw_plan(k: int, v_out: int, cin: int, cout: int,
             bf16: bool = True) -> tuple[int, int]:
    """(taps a block, split) of a K5 launch: the grid is (Cin x Cout
    tiles, ceil(K / group) tap groups, split), and block z walks steps z,
    z + split, z + 2 split, ... of the rulebook's rows (32 rows a step for
    bf16; f32 takes one tap a block and 64-row steps), so that a padded
    tail of rows that miss spreads over all blocks.  Every block has at
    least one step."""
    ti = 32 if cin <= 32 else 64
    tj = 32 if cout <= 32 else 64
    rows = _DW_STEP_ROWS if bf16 else _DW_FMA_ROWS
    n_steps = max(1, -(-v_out // rows))
    group = _DW_GROUP if bf16 and n_steps > _DW_FEW_STEPS else 1
    fill = (_DW_FMA_FILL_BLOCKS if not bf16 else _DW_WIDE_FILL_BLOCKS
            if group > 1 and ti == tj == 64 else _DW_FILL_BLOCKS)
    base = -(-k // group) * -(-cin // ti) * -(-cout // tj)
    return group, min(n_steps, 65535, max(1, -(-fill // base)))


def _rows_of_8(t: torch.Tensor) -> torch.Tensor:
    """``t`` (V, C) with zero channels appended up to a multiple of 8."""
    pad = -t.shape[1] % 8
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied when its data is not 16-byte aligned (the kernels load
    16-byte vectors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
