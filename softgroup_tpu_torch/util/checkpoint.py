"""Checkpoints of the port's train CLI, and the import of the reference's
released ``.pth`` checkpoints.

``CheckpointManager`` (counterpart of ``softgroup_tpu/util/checkpoint.py``'s
orbax manager, written with ``torch.save``): ``work_dir/ckpt/epoch_N``
files, a ``latest`` file naming the newest, and the retention of
``should_keep`` (the reference's ``util/utils.py:88-108``: power-of-2 and
``save_freq`` epochs stay, every other one goes when the next is saved).
A checkpoint holds the net's state dict (batch-norm running statistics
included), the optimizer's, the epoch and the update count.
``load_weights`` tells a port checkpoint from a reference ``.pth`` by its
keys.

The import half is a copy of the reference's (``load_reference_state_dict``,
``import_reference_weights`` and its name and layout translation).  The
port's state dict keys are the JAX package's variable paths joined by
dots (``util/convert.py``), so the reference key of a port key is
``_translate`` of its parts:
  input_conv.kernel                  -> input_conv.0.weight
  unet. ... .block{i}. ...           -> unet. ... .blocks.block{i}.conv_branch.*
  MLP heads (Linear/BN/ReLU/Linear)  -> sequential indices 0/1/3 (normed)
                                        or 0/2 (the norm-free mask_linear)
Layouts: a spconv2 kernel is (Cout, k, k, k, Cin); flattening its spatial
dims x-major gives the port's tap order, (taps, Cin, Cout).  A torch Linear
(out, in) transposes to (in, out).  ``reference_state_dict`` is the
inverse: the port's weights in the reference's keys and layouts.
"""

from __future__ import annotations

import contextlib
import os
import re

import numpy as np
import torch


def is_power2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def should_keep(epoch: int, save_freq: int) -> bool:
    """Whether epoch ``epoch``'s checkpoint outlives the next one."""
    return is_power2(epoch) or bool(save_freq and epoch % save_freq == 0)


def _write(path: str, write) -> None:
    """``write(tmp)``, then ``tmp`` renamed to ``path``: a reader never
    finds a half-written file."""
    tmp = f'{path}.{os.getpid()}.tmp'
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.remove(tmp)


class CheckpointManager:
    """Saves and restores a ``train.TrainState`` (net, optimizer, update
    count) under ``work_dir/ckpt``."""

    def __init__(self, work_dir: str, save_freq: int = 0, rank: int = 0):
        self.dir = os.path.abspath(os.path.join(work_dir, 'ckpt'))
        self.save_freq = save_freq
        self.rank = rank
        if rank == 0:
            os.makedirs(self.dir, exist_ok=True)

    def path(self, epoch: int) -> str:
        return os.path.join(self.dir, f'epoch_{epoch}')

    def save(self, state, epoch: int):
        if self.rank != 0:
            return
        ckpt = dict(net=state.net.state_dict(),
                    optimizer=state.optimizer.state_dict(), epoch=epoch,
                    updates=state.step.updates)
        _write(self.path(epoch), lambda p: torch.save(ckpt, p))

        def latest(p):
            with open(p, 'w') as f:
                f.write(f'epoch_{epoch}')
        _write(os.path.join(self.dir, 'latest'), latest)
        prev = epoch - 1
        if prev > 0 and not should_keep(prev, self.save_freq):
            with contextlib.suppress(FileNotFoundError):
                os.remove(self.path(prev))

    def latest_epoch(self) -> int | None:
        latest = os.path.join(self.dir, 'latest')
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            m = re.match(r'epoch_(\d+)', f.read().strip())
        return int(m.group(1)) if m else None

    def load(self, state, epoch: int | None = None) -> int:
        """Restores ``state`` (net, optimizer, update count) from epoch
        ``epoch``'s checkpoint (default the latest) and returns the epoch
        to train next; 1, with ``state`` untouched, where there is none."""
        if epoch is None:
            epoch = self.latest_epoch()
            if epoch is None:
                return 1
        ckpt = torch.load(self.path(epoch), map_location='cpu',
                          weights_only=True)
        state.net.load_state_dict(ckpt['net'])
        state.optimizer.load_state_dict(ckpt['optimizer'])
        state.step.updates = int(ckpt['updates'])
        return int(ckpt['epoch']) + 1


def _reference_arrays(sd: dict) -> dict:
    return {k.replace('module.', ''): np.asarray(v.detach().cpu().numpy())
            for k, v in sd.items()}


def load_reference_state_dict(path: str) -> dict:
    """The numpy state dict of a reference ``.pth`` (its ``net`` entry
    where it has one), ``module.`` prefixes dropped."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    return _reference_arrays(ckpt.get('net', ckpt))


def load_weights(net, path: str, logger=None) -> None:
    """Loads the weights of the checkpoint at ``path`` into ``net``: a
    checkpoint of the train CLI (the net's own state dict keys, loaded as
    they are) or a released ``.pth`` (through
    ``import_reference_weights``)."""
    if not os.path.isfile(path):
        raise ValueError(f'{path} is not a checkpoint file: give a train '
                         f'CLI checkpoint (work_dir/ckpt/epoch_N) or a '
                         f'reference .pth')
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    sd = ckpt.get('net', ckpt)
    own = net.state_dict()
    if set(sd) == set(own):
        net.load_state_dict(sd)
        if logger:
            logger.info(f'loaded the port checkpoint {path} (epoch '
                        f'{ckpt.get("epoch")})')
        return
    net.load_state_dict(import_reference_weights(
        own, _reference_arrays(sd), logger))


_BN_LEAF = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
            'var': 'running_var'}


def _translate(path: tuple[str, ...]) -> str | None:
    """A port (JAX) variable path -> its reference state_dict key."""
    parts = list(path)
    out: list[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == 'input_conv':
            return 'input_conv.0.' + _leaf(parts[i + 1:])
        if p == 'output_norm':
            return 'output_layer.0.' + _leaf(parts[i + 1:])
        if p == 'tiny_output_norm':
            return 'tiny_unet_outputlayer.0.' + _leaf(parts[i + 1:])
        if p in ('cls_linear', 'iou_score_linear'):
            return f'{p}.' + _leaf(parts[i + 1:])
        if p in ('semantic_linear', 'offset_linear', 'mask_linear'):
            return f'{p}.' + _mlp_leaf(parts[i + 1:], normed=p != 'mask_linear')
        if p in ('unet', 'tiny_unet', 'u'):
            out.append(p)
        elif re.match(r'block_tail\d+$', p):
            out.append('blocks_tail.' + p.replace('_tail', ''))
            return '.'.join(out) + '.' + _resblock_leaf(parts[i + 1:])
        elif re.match(r'block\d+$', p):
            out.append(f'blocks.{p}')
            return '.'.join(out) + '.' + _resblock_leaf(parts[i + 1:])
        elif p == 'conv_norm':
            return '.'.join(out) + '.conv.0.' + _leaf(parts[i + 1:])
        elif p == 'conv':
            return '.'.join(out) + '.conv.2.' + _leaf(parts[i + 1:])
        elif p == 'deconv_norm':
            return '.'.join(out) + '.deconv.0.' + _leaf(parts[i + 1:])
        elif p == 'deconv':
            return '.'.join(out) + '.deconv.2.' + _leaf(parts[i + 1:])
        else:
            return None
        i += 1
    return None


def _leaf(rest: list[str]) -> str:
    leaf = rest[-1]
    if leaf == 'kernel':
        return 'weight'
    return _BN_LEAF.get(leaf, leaf)


def _resblock_leaf(rest: list[str]) -> str:
    sub = {'norm1': 'conv_branch.0', 'conv1': 'conv_branch.2',
           'norm2': 'conv_branch.3', 'conv2': 'conv_branch.5'}
    if rest[0] == 'i_branch_kernel':
        return 'i_branch.0.weight'
    if rest[0] in sub:
        return sub[rest[0]] + '.' + _leaf(rest[1:])
    return '.'.join(rest)


def _mlp_leaf(rest: list[str], normed: bool) -> str:
    leaf = rest[0]
    m = re.match(r'hidden(\d+)_(kernel|bias)$', leaf)
    stride = 3 if normed else 2
    if m:
        i = int(m.group(1))
        return f'{i * stride}.' + ('weight' if m.group(2) == 'kernel'
                                   else 'bias')
    m = re.match(r'norm(\d+)$', leaf)
    if m:
        return f'{int(m.group(1)) * stride + 1}.' + _leaf(rest[1:])
    if leaf == 'final_kernel':
        return _final(stride, 'weight')
    if leaf == 'final_bias':
        return _final(stride, 'bias')
    return '.'.join(rest)


def _final(stride: int, leaf: str) -> str:
    # the final linear follows (num_layers - 1) groups; num_layers is 2
    # in every head
    return f'{stride}.{leaf}'


def _convert(src: np.ndarray, dst_shape) -> np.ndarray | None:
    """A reference tensor in the port's layout of ``dst_shape``, or None
    where the shapes do not fit."""
    if src.ndim == 5:  # spconv kernel (Cout, k, k, k, Cin)
        cout, cin = src.shape[0], src.shape[-1]
        taps = int(np.prod(src.shape[1:4]))
        w = np.transpose(src.reshape(cout, taps, cin), (1, 2, 0))
        if taps == 1 and tuple(dst_shape) == (cin, cout):
            return np.ascontiguousarray(w[0])  # 1x1 conv -> dense
        return np.ascontiguousarray(w) if w.shape == tuple(dst_shape) else None
    if src.ndim == 2 and tuple(dst_shape) == tuple(src.shape[::-1]):
        return np.ascontiguousarray(src.T)  # torch Linear (out,in) -> (in,out)
    if tuple(dst_shape) == tuple(src.shape):
        return src
    return None


def import_reference_weights(state: dict, torch_state: dict,
                             logger=None) -> dict:
    """A copy of the port's state dict ``state`` with every translatable
    tensor replaced by the reference's value (``torch_state``: numpy
    arrays by reference key).  Tolerant, as the reference's loader: a
    missing or mismatched tensor keeps its value and logs a line; the
    last line is ``import: loaded n/m tensors``."""
    n_hit = 0
    out = {}
    for key, leaf in state.items():
        parts = tuple(key.split('.'))
        ref = _translate(parts)
        src = torch_state.get(ref) if ref else None
        if src is not None:
            conv = _convert(src, tuple(leaf.shape))
            if conv is not None:
                out[key] = torch.as_tensor(np.asarray(conv)).to(
                    dtype=leaf.dtype, device=leaf.device)
                n_hit += 1
                continue
            if logger:
                logger.info(f'import: shape mismatch {ref} {src.shape} '
                            f'vs {tuple(leaf.shape)}')
        elif logger and ref:
            logger.info(f'import: missing {ref} for {"/".join(parts)}')
        out[key] = leaf
    if logger:
        logger.info(f'import: loaded {n_hit}/{len(state)} tensors')
    return out


def reference_state_dict(state: dict) -> dict:
    """The inverse of ``import_reference_weights``: the port's state dict
    as f32 CPU tensors under the reference's keys and layouts (spconv
    kernels (Cout, k, k, k, Cin), Linear weights (out, in)), as a
    released ``.pth`` holds them."""
    out = {}
    for key, leaf in state.items():
        ref = _translate(tuple(key.split('.')))
        if ref is None:
            raise KeyError(f'{key} has no reference key')
        w = leaf.detach().float().cpu()
        if w.dim() == 3:    # (taps, Cin, Cout) -> (Cout, k, k, k, Cin)
            k = round(w.shape[0] ** (1 / 3))
            w = w.permute(2, 0, 1).reshape(w.shape[2], k, k, k, w.shape[1])
        elif ref.endswith('i_branch.0.weight'):   # 1x1 conv (Cin, Cout)
            w = w.T.reshape(w.shape[1], 1, 1, 1, w.shape[0])
        elif w.dim() == 2:  # dense (in, out) -> Linear (out, in)
            w = w.T
        out[ref] = w.contiguous()
    return out
