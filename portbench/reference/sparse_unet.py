"""Plain PyTorch reference of the SoftGroup backbone: voxelization, the
k2s2 pyramid, submanifold / strided / inverse sparse convs, the residual
U-Net, batch norm, devoxelization and the point heads.

Written from the architecture's definition, not from the program: it
imports nothing of the program, builds its own voxels and neighbour lists
from the raw points on the device (sorted keys and ``searchsorted``), and
differentiates with autograd.  Weights are a dict of tensors under the
program's state-dict names.  Products are float32 with TF32 off, or, for
the control, operands rounded to a lower precision (``Precision``).

Tap order (the published layout of the kernels): a submanifold tap k is
the neighbour at offset (dx, dy, dz) with k = (dx+1)*9 + (dy+1)*3 + (dz+1);
a strided tap t of a child voxel is (x&1)*4 + (y&1)*2 + (z&1).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

SUBM_OFFSETS = tuple(itertools.product((-1, 0, 1), repeat=3))
BN_EPS = 1e-4


# ---------------------------------------------------------------------------
# Precision of the products
# ---------------------------------------------------------------------------

def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (amax to
    448), back in f32."""
    s = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _RoundForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class Precision:
    """``'f32'``: plain float32 products.  ``'fp8'``: every product's
    operands (features, weights) rounded to float8 e4m3 and summed in f32,
    its result stored in float8, and the cotangent of its result rounded
    to float8 (the control: the bf16 policy of the program, one precision
    lower)."""

    def __init__(self, name: str = 'f32'):
        if name not in ('f32', 'fp8'):
            raise ValueError(f'unknown precision {name}')
        self.name = name

    def operand(self, x):
        return x if self.name == 'f32' else _RoundForward.apply(x)

    def output(self, y):
        return y if self.name == 'f32' else _RoundBoth.apply(y)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

@dataclass
class Level:
    n: int                      # voxels
    coords: torch.Tensor        # (n, 4) int64: batch, x, y, z
    subm: list                  # 27 x (out rows, in rows)
    # (n,) row of the coarser level; n_parent where a cap left it none
    parent: torch.Tensor | None = None
    tap: torch.Tensor | None = None      # (n,) strided tap
    n_parent: int = 0


def _keys(c: torch.Tensor, span: int) -> torch.Tensor:
    """Linear keys of (b, x, y, z) with x, y, z in [-1, span - 1)."""
    return ((c[:, 0] * span + c[:, 1] + 1) * span + c[:, 2] + 1) * span \
        + c[:, 3] + 1


def _unique_rows(c: torch.Tensor, span: int):
    keys, inverse = torch.unique(_keys(c, span), return_inverse=True)
    z = keys % span - 1
    y = keys // span % span - 1
    x = keys // span ** 2 % span - 1
    b = keys // span ** 3
    return torch.stack([b, x, y, z], 1), keys, inverse


def _subm_pairs(coords: torch.Tensor, keys: torch.Tensor, span: int):
    pairs = []
    n = coords.shape[0]
    rows = torch.arange(n, device=coords.device)
    for off in SUBM_OFFSETS:
        q = coords.clone()
        q[:, 1:] += torch.tensor(off, device=coords.device)
        ok = (q[:, 1:] >= 0).all(1)
        qk = _keys(q, span)
        pos = torch.searchsorted(keys, qk).clamp(max=n - 1)
        hit = ok & (keys[pos] == qk)
        pairs.append((rows[hit], pos[hit]))
    return pairs


def build_levels(c4: torch.Tensor, num_levels: int):
    """(levels, p2v) of points with voxel coords ``c4`` (N, 4) int64."""
    span = int(c4[:, 1:].max()) + 3
    coords, keys, p2v = _unique_rows(c4, span)
    levels = []
    for lvl in range(num_levels):
        lv = Level(coords.shape[0], coords, _subm_pairs(coords, keys, span))
        levels.append(lv)
        if lvl + 1 == num_levels:
            break
        parent_c = coords.clone()
        parent_c[:, 1:] = torch.div(coords[:, 1:], 2, rounding_mode='floor')
        xyz = coords[:, 1:]
        lv.tap = (xyz[:, 0] & 1) * 4 + (xyz[:, 1] & 1) * 2 + (xyz[:, 2] & 1)
        coords, keys, lv.parent = _unique_rows(parent_c, span)
        lv.n_parent = coords.shape[0]
    return levels, p2v


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def subm_conv(x, w, lv: Level, prec: Precision):
    xq, wq = prec.operand(x), prec.operand(w)
    out = x.new_zeros((lv.n, w.shape[2]))
    for k, (o, i) in enumerate(lv.subm):
        out = out.index_add(0, o, (xq @ wq[k])[i])
    return prec.output(out)


def down_conv(x, w, lv: Level, prec: Precision):
    xq, wq = prec.operand(x), prec.operand(w)
    out = x.new_zeros((lv.n_parent, w.shape[2]))
    rows = torch.arange(lv.n, device=x.device)
    for t in range(w.shape[0]):
        m = (lv.tap == t) & (lv.parent < lv.n_parent)
        out = out.index_add(0, lv.parent[m], xq[rows[m]] @ wq[t])
    return prec.output(out)


def inverse_conv(x, w, lv: Level, prec: Precision):
    """``x`` on the coarser level, ``lv`` the finer one."""
    xq, wq = prec.operand(x), prec.operand(w)
    out = x.new_zeros((lv.n, w.shape[2]))
    rows = torch.arange(lv.n, device=x.device)
    for t in range(w.shape[0]):
        m = (lv.tap == t) & (lv.parent < lv.n_parent)
        out = out.index_add(0, rows[m], xq[lv.parent[m]] @ wq[t])
    return prec.output(out)


def dense(x, w, b, prec: Precision):
    """(x @ w + b), the result (bias included) stored in the precision."""
    y = prec.operand(x) @ prec.operand(w)
    return prec.output(y if b is None else y + b)


def batch_norm(x, P: dict, name: str, train: bool = True):
    """Train mode: the biased batch statistics of every row; eval mode:
    the running statistics."""
    if train:
        mean = x.mean(0)
        var = (x - mean).square().mean(0)
    else:
        mean, var = P[f'{name}.mean'], P[f'{name}.var']
    return (x - mean) * torch.rsqrt(var + BN_EPS) * P[f'{name}.scale'] \
        + P[f'{name}.bias']


def _blocks(P: dict, prefix: str, stem: str) -> list:
    n = 0
    while f'{prefix}.{stem}{n}.conv1.kernel' in P:
        n += 1
    return [f'{prefix}.{stem}{i}' for i in range(n)]


def residual(x, lv: Level, P: dict, name: str, prec: Precision,
             train: bool = True):
    ident = (dense(x, P[f'{name}.i_branch_kernel'], None, prec)
             if f'{name}.i_branch_kernel' in P else x)
    y = subm_conv(torch.relu(batch_norm(x, P, f'{name}.norm1', train)),
                  P[f'{name}.conv1.kernel'], lv, prec)
    y = subm_conv(torch.relu(batch_norm(y, P, f'{name}.norm2', train)),
                  P[f'{name}.conv2.kernel'], lv, prec)
    return y + ident


def unet(x, levels: list, P: dict, name: str, prec: Precision,
         train: bool = True):
    lv = levels[0]
    for b in _blocks(P, name, 'block'):
        x = residual(x, lv, P, b, prec, train)
    if f'{name}.conv.kernel' in P:
        y = down_conv(torch.relu(batch_norm(x, P, f'{name}.conv_norm', train)),
                      P[f'{name}.conv.kernel'], lv, prec)
        y = unet(y, levels[1:], P, f'{name}.u', prec, train)
        y = inverse_conv(
            torch.relu(batch_norm(y, P, f'{name}.deconv_norm', train)),
            P[f'{name}.deconv.kernel'], lv, prec)
        x = torch.cat([x, y], 1)
        for b in _blocks(P, name, 'block_tail'):
            x = residual(x, lv, P, b, prec, train)
    return x


def mlp(x, P: dict, name: str, prec: Precision, train: bool = True):
    i = 0
    while f'{name}.hidden{i}_kernel' in P:
        x = dense(x, P[f'{name}.hidden{i}_kernel'], P[f'{name}.hidden{i}_bias'],
                  prec)
        if f'{name}.norm{i}.scale' in P:
            x = batch_norm(x, P, f'{name}.norm{i}', train)
        x = torch.relu(x)
        i += 1
    return dense(x, P[f'{name}.final_kernel'], P[f'{name}.final_bias'], prec)


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------

@dataclass
class Scene:
    """One batch of rooms as the reference sees it."""
    levels: list
    p2v: torch.Tensor           # (N,) level-0 voxel of each point
    vox_in: torch.Tensor        # (V0, C_in) mean input features
    xyz: torch.Tensor           # (N, 3) f32
    semantic: torch.Tensor      # (N,) int64
    offset_label: torch.Tensor  # (N, 3) f32: instance centroid - point
    instance_pos: torch.Tensor  # (N,) bool: the point has an instance


def voxel_coords(xyz: np.ndarray, scale: float) -> np.ndarray:
    """Integer grid coordinates of a room: ``xyz * scale`` shifted to start
    at 0, floored (float32 arithmetic)."""
    s = xyz.astype(np.float32) * np.float32(scale)
    return np.floor(s - s.min(0)).astype(np.int64)


def scene(rooms, scale: float, num_levels: int, with_coords: bool,
          ignore_label: int, device) -> Scene:
    """``rooms``: [(xyz, rgb, semantic, instance), ...] as the generator
    made them, one batch item each."""
    c4, xyz, rgb, sem, inst = [], [], [], [], []
    for b, (x, r, s, i) in enumerate(rooms):
        g = voxel_coords(x, scale)
        c4.append(np.concatenate([np.full((len(x), 1), b), g], 1))
        xyz.append(x)
        rgb.append(r)
        sem.append(s)
        # instance ids made unique over the batch
        inst.append(np.where(i >= 0, i.astype(np.int64) + b * 2 ** 20, -1))
    t = lambda a, dt: torch.as_tensor(np.concatenate(a)).to(device, dt)
    c4 = t(c4, torch.int64)
    xyz_t, rgb_t = t(xyz, torch.float32), t(rgb, torch.float32)
    levels, p2v = build_levels(c4, num_levels)
    feats = torch.cat([rgb_t, xyz_t], 1) if with_coords else rgb_t
    v0 = levels[0].n
    count = torch.zeros(v0, dtype=torch.float64, device=device).index_add_(
        0, p2v, torch.ones_like(p2v, dtype=torch.float64))
    vox_in = (torch.zeros((v0, feats.shape[1]), dtype=torch.float64,
                          device=device).index_add_(0, p2v, feats.double())
              / count[:, None]).float()
    inst_t = t(inst, torch.int64)
    pos = inst_t >= 0
    ids, inv = torch.unique(torch.where(pos, inst_t, -1), return_inverse=True)
    sums = torch.zeros((len(ids), 3), dtype=torch.float64,
                       device=device).index_add_(0, inv, xyz_t.double())
    cnt = torch.zeros(len(ids), dtype=torch.float64,
                      device=device).index_add_(0, inv,
                                                torch.ones_like(xyz_t[:, 0],
                                                                dtype=torch.float64))
    centroid = (sums / cnt[:, None]).float()
    offset = torch.where(pos[:, None], centroid[inv] - xyz_t, 0.0)
    semantic = t(sem, torch.int64)
    semantic = torch.where(semantic == ignore_label, -1, semantic)
    return Scene(levels, p2v, vox_in, xyz_t, semantic, offset, pos)


def point_heads(P: dict, sc: Scene, prec: Precision, train: bool = True):
    """(semantic scores, offsets, point features) of a scene, every batch
    norm in train mode (``train``) or on its running statistics."""
    x = subm_conv(sc.vox_in, P['input_conv.kernel'], sc.levels[0], prec)
    x = unet(x, sc.levels, P, 'unet', prec, train)
    x = torch.relu(batch_norm(x, P, 'output_norm', train))
    f = x[sc.p2v]
    return (mlp(f, P, 'semantic_linear', prec, train),
            mlp(f, P, 'offset_linear', prec, train), f)


def point_loss(sem, off, sc: Scene):
    """Semantic cross entropy over the labelled points + the L1 distance
    of the offsets to the instance centroids over the instance points."""
    lab = sc.semantic >= 0
    ce = torch.nn.functional.cross_entropy(sem[lab], sc.semantic[lab])
    n_pos = sc.instance_pos.sum().clamp(min=1)
    l1 = (off - sc.offset_label).abs().sum(1)
    return ce + (l1 * sc.instance_pos).sum() / n_pos, ce


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def adam_steps(P0: dict, trainable: list, scenes: list, lrs: list,
               b1: float, b2: float, eps: float, prec: Precision) -> dict:
    """Adam over ``scenes`` from the weights ``P0``, step k at learning
    rate ``lrs[k]``: per step the loss, each leaf's gradient of step 1 and
    its change over the steps."""
    P = {k: v.detach().clone() for k, v in P0.items()}
    m = {k: torch.zeros_like(P[k]) for k in trainable}
    v = {k: torch.zeros_like(P[k]) for k in trainable}
    losses, grad = [], {}
    for step, (sc, lr) in enumerate(zip(scenes, lrs), 1):
        for k in trainable:
            P[k].requires_grad_(True)
        sem, off, _ = point_heads(P, sc, prec)
        loss, _ = point_loss(sem, off, sc)
        grads = torch.autograd.grad(loss, [P[k] for k in trainable])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in zip(trainable, grads):
                if step == 1:
                    grad[k] = g.detach().clone()
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[k] / (1 - b1 ** step)
                vh = v[k] / (1 - b2 ** step)
                P[k] = (P[k] - lr * mh / (vh.sqrt() + eps)).detach()
        del sem, off, loss, grads
    delta = {k: (P[k] - P0[k]).detach() for k in trainable}
    return dict(losses=losses, grad=grad, delta=delta)


class NoTF32:
    """Float32 products without TF32 inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
