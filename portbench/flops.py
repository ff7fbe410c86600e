"""Model FLOPs of a SoftGroup backbone pass, counted from the weights'
names and shapes and the batch's own rulebooks.

* A submanifold conv counts 2 x (its level's valid rulebook hits) x Cin x
  Cout; a strided conv and its inverse 2 x (fine voxels) x Cin x Cout (one
  parent a voxel); a 1x1 branch 2 x (voxels) x Cin x Cout; a point head's
  linear layer 2 x (points) x Cin x Cout.
* Training counts a trained layer's forward, input gradient and weight
  gradient (3x); the input conv has no input gradient (2x); a frozen
  layer counts its forward alone.

Batch norm, ReLU, gathers and the loss are left out: they are bytes, not
FLOPs.
"""

from __future__ import annotations


def _level(name: str) -> int:
    return name.split('.').count('u')


def layer_flops(name: str, shape, hits: list, voxels: list,
                points: int) -> int:
    """The forward FLOPs of the layer whose kernel is ``name``."""
    cin, cout = shape[-2], shape[-1]
    if name == 'input_conv.kernel':
        rows = hits[0]
    elif name.startswith('unet.'):
        lvl = _level(name)
        if name.endswith(('conv1.kernel', 'conv2.kernel')):
            rows = hits[lvl]
        elif name.endswith(('.conv.kernel', '.deconv.kernel',
                            'i_branch_kernel')):
            rows = voxels[lvl]
        else:
            raise ValueError(f'unknown backbone layer {name}')
    elif name.startswith(('semantic_linear.', 'offset_linear.')):
        rows = points
    else:
        return 0      # the refinement head: not part of a backbone pass
    return 2 * rows * cin * cout


def backbone_flops(shapes: dict, hits: list, voxels: list, points: int,
                   trained=lambda name: True, train: bool = True) -> int:
    """FLOPs of one backbone pass over a batch: ``shapes`` {name: shape}
    of the weights, ``hits`` / ``voxels`` per pyramid level, ``points``
    the valid points; ``train``: forward and backward, ``trained(name)``
    telling which layers are trained."""
    total = 0
    for name, shape in shapes.items():
        if not name.endswith('kernel'):
            continue
        f = layer_flops(name, shape, hits, voxels, points)
        if train and trained(name):
            f *= 2 if name == 'input_conv.kernel' else 3
        total += f
    return total


def pyramid_counts(pyramid) -> tuple[list, list, int]:
    """(valid hits, valid voxels) per level and valid points of a
    program's ``Pyramid`` (padded columns hold no hits)."""
    hits = [int((lv.subm_rules >= 0).sum()) for lv in pyramid.levels]
    voxels = [int(lv.vox_valid.sum()) for lv in pyramid.levels]
    return hits, voxels, int(pyramid.point_valid.sum())
