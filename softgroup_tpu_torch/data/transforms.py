"""Point-cloud augmentations and geometric transforms (host, numpy): a copy
of ``softgroup_tpu/data/transforms.py``.

Semantics match the reference training pipeline bit-for-bit where it matters
for metric parity (`softgroup/data/custom.py`):
  * elastic distortion — triple-blurred gaussian noise grids interpolated at
    point locations (custom.py:52-74);
  * jitter/flip/rotation augment with the deterministic "slight rotation"
    (theta = 0.35*pi) applied when rotation is disabled, which the released
    checkpoints expect (custom.py:92-111);
  * crop to max_npoint by sliding a shrinking spatial window (custom.py:113-127);
  * instance relabeling after cropping (custom.py:129-136).
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate
import scipy.ndimage


def elastic_distort(x: np.ndarray, granularity: float, magnitude: float,
                    rng: np.random.RandomState) -> np.ndarray:
    """Smooth random displacement field sampled on a coarse grid."""
    grid_dim = np.abs(x).max(0).astype(np.int32) // granularity + 3
    fields = []
    blurs = [np.ones((3, 1, 1), np.float32) / 3,
             np.ones((1, 3, 1), np.float32) / 3,
             np.ones((1, 1, 3), np.float32) / 3]
    for _ in range(3):
        noise = rng.randn(*grid_dim).astype(np.float32)
        for _ in range(2):
            for b in blurs:
                noise = scipy.ndimage.convolve(noise, b, mode='constant',
                                               cval=0)
        fields.append(noise)
    axes = [np.linspace(-(d - 1) * granularity, (d - 1) * granularity, d)
            for d in grid_dim]
    interp = [scipy.interpolate.RegularGridInterpolator(
        axes, f, bounds_error=False, fill_value=0) for f in fields]
    disp = np.stack([f(x) for f in interp], axis=1)
    return x + disp * magnitude


def augment_xyz(xyz: np.ndarray, rng: np.random.RandomState,
                jitter: bool = False, flip: bool = False, rot: bool = False,
                scale: bool = False, prob: float = 1.0) -> np.ndarray:
    """Random linear augment; when rot is off, the fixed 0.35*pi rotation is
    applied (checkpoint-matching detail, custom.py:103-107)."""
    m = np.eye(3)
    if jitter and rng.rand() < prob:
        m = m + rng.randn(3, 3) * 0.1
    if flip and rng.rand() < prob:
        m[0][0] *= rng.randint(0, 2) * 2 - 1
    if rot and rng.rand() < prob:
        theta = rng.rand() * 2 * np.pi
    else:
        theta = 0.35 * np.pi
    c, s = np.cos(theta), np.sin(theta)
    m = m @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    if scale and rng.rand() < prob:
        xyz = xyz * rng.uniform(0.95, 1.05)
    return xyz @ m


def crop_to_size(xyz: np.ndarray, max_npoint: int, full_scale: int,
                 rng: np.random.RandomState, step: int = 32):
    """Slide a shrinking [0, spatial)^3 window until <= max_npoint points
    remain; returns (offset xyz, valid mask)."""
    offset_xyz = xyz.copy()
    valid = offset_xyz.min(1) >= 0
    spatial = np.full(3, full_scale, np.float64)
    room = xyz.max(0) - xyz.min(0)
    while valid.sum() > max_npoint:
        s = step * 2 if valid.sum() > 1e6 else step
        offset = np.clip(spatial - room + 0.001, None, 0) * rng.rand(3)
        offset_xyz = xyz + offset
        valid = (offset_xyz.min(1) >= 0) \
            & ((offset_xyz < spatial).sum(1) == 3)
        spatial[:2] -= s
    return offset_xyz, valid


def relabel_instances(instance_label: np.ndarray,
                      valid: np.ndarray) -> np.ndarray:
    """Compact instance ids to a dense 0..K-1 range after cropping, keeping
    negative (ignore) labels."""
    inst = instance_label[valid].copy()
    pos = inst >= 0
    if pos.any():
        uniq = np.unique(inst[pos])
        remap = np.full(int(uniq.max()) + 1, -1, inst.dtype)
        remap[uniq] = np.arange(len(uniq), dtype=inst.dtype)
        inst[pos] = remap[inst[pos]]
    return inst
