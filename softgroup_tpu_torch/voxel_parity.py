"""Card-vs-CPU parity of the proposal voxelization over augmentation draws
of the ScanNet train CLI's first batch.

    python -m softgroup_tpu_torch.voxel_parity [draws]

The rooms ``chip_smoke.py`` writes for its train CLI phase, the stage-2
yaml's capacities, the batch's instances as proposals and the
quantization draws of ``chip_smoke.cli_positive_check``; draw k augments
the batch from seed k.  One line a draw: the entries whose proposal grid
cell differs between the card and the CPU with the port's division of the
proposal extent by ``spatial_shape`` (a product with the f32 reciprocal,
as the reference's XLA computes it), with ``extent / spatial_shape`` in
its place (a true f32 quotient on the CPU, the same product on the card),
and the entries whose voxel from ``clusters_voxelization`` differs; then
the draws where each parts.  Needs a card.
"""
import sys
import tempfile

import numpy as np
import torch

from .model import softgroup as sg
from .ops.segment import segment_max, segment_min
from .time_kernels import _chip_smoke


def cells(props, coords_float, scale, shape, rand, quotient):
    """Each entry's grid cell as ``clusters_voxelization`` floors it, the
    extent divided by ``shape`` as a product with the f32 reciprocal or,
    with ``quotient``, by ``/``."""
    p_max = props.prop_valid.shape[0]
    coords = coords_float[props.entry_pt.long()]
    seg = torch.where(props.entry_valid, props.entry_seg, p_max)
    cmin = segment_min(coords, seg, p_max)
    cmax = segment_max(coords, seg, p_max)
    extent = (cmax - cmin).amax(dim=1)
    q = extent / shape if quotient else extent * float(
        np.float32(1.0) / np.float32(shape))
    cs = (1.0 / q.clamp(min=1e-12) - 0.01).clamp(max=scale)
    cmin_s = cmin * cs[:, None]
    rng_range = cmax * cs[:, None] - cmin_s
    cmin_s = cmin_s - (shape - rng_range - 0.001).clamp(min=0) * rand[0]
    cmin_s = cmin_s - (shape - rng_range + 0.001).clamp(max=0) * rand[1]
    pe = torch.cat([cs[:, None], cmin_s], dim=1)[seg.long().clamp(
        0, p_max - 1)]
    return torch.floor(coords * pe[:, :1] - pe[:, 1:]).clamp(0, shape - 1)


def main(argv=None) -> int:
    from .tools_impl import train_cli
    from .util.config import load_config
    argv = sys.argv[1:] if argv is None else argv
    draws = int(argv[0]) if argv else 40
    chip = _chip_smoke()
    root = tempfile.TemporaryDirectory(prefix='voxel_parity_')
    paths = chip.scannet_rooms(root.name)
    cfg = load_config(paths[1])
    caps = train_cli.caps_from_cfg(cfg)
    scale = float(cfg.model.instance_voxel_cfg.scale)
    shape = int(cfg.model.instance_voxel_cfg.spatial_shape)
    rand = torch.tensor(chip.CLI_POSITIVE_RAND)
    parted = {'product': [], 'quotient': [], 'voxels': []}
    for seed in range(draws):
        batch, _ = chip.host_batch(paths[0], seed)
        props = chip.instance_proposals(batch, caps)
        out = {}
        for dev in ('cpu', 'cuda'):
            pr = sg.Proposals(*(t.to(dev) for t in props))
            xyz, r = batch.coords_float.to(dev), rand.to(dev)
            with torch.no_grad():
                out[dev] = dict(
                    product=cells(pr, xyz, scale, shape, r, False).cpu(),
                    quotient=cells(pr, xyz, scale, shape, r, True).cpu(),
                    voxels=sg.clusters_voxelization(
                        pr, xyz.new_zeros((xyz.shape[0], 1)), xyz, scale,
                        shape, caps, rand=r)[2].cpu())
        valid = props.entry_valid
        apart = {}
        for k in parted:
            a, c = out['cuda'][k], out['cpu'][k]
            ne = a != c
            apart[k] = int((ne.any(dim=1) if ne.dim() > 1 else ne)[valid]
                           .sum())
            if apart[k]:
                parted[k].append(seed)
        print(f'voxel_parity draw {seed}: {int(valid.sum())} entries; '
              f'entries apart, card vs CPU: product {apart["product"]}, '
              f'quotient {apart["quotient"]}, clusters_voxelization '
              f'{apart["voxels"]}', flush=True)
    print(f'voxel_parity: draws apart of {draws}: ' + ', '.join(
        f'{k} {len(v)} {v}' for k, v in parted.items()), flush=True)
    root.cleanup()
    return 0


if __name__ == '__main__':
    sys.exit(main())
