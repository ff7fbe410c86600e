"""Entry points of the port: the flagship ScanNet model (channels 32, 7 U-Net
levels, 20 semantic / 18 instance classes).

* Serving: its config and the bench capacities, the host batch and
  ``test_forward``.  A request is ``build_batch`` -> ``infer`` ->
  ``evaluation.postprocess.get_instances``.  Counterpart of
  ``__graft_entry__._net_cfg`` / ``_build`` and the capacities of
  ``bench.py``.
* SoftGroup++ serving: the model section of
  ``configs/softgroup_pp/softgroup++_scannet.yaml`` (``plus_cfg``: scene
  pyramid grouping, lvl_fusion) and the inference runner
  (``build_runner``): a request is ``runner.run_scene(data)`` on one
  collated scan, ``test_forward_plus`` at per-scene bucketed capacities.
  Counterpart of ``tools_impl/test_runner.InferenceRunner``.
* Training: the model section of ``configs/softgroup/softgroup_scannet.yaml``
  (``train_cfg``), the batch-4 capacities of ``tools/bench_train_batch4.py``
  (``train_capacities``), a collated batch of scenes and the train state
  (net, Adam, step).  Counterpart of ``tools/train.py``'s ``caps_from_cfg``
  / ``build_net`` and ``tools/bench_train_batch4.py``.

``chip_smoke.py`` drives all three.  Everything runs on ``device`` (default the
card); pass ``device="cpu"`` for the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import os

import torch

from .data.padding import build_scene_batch
from .data.synthetic import collate_scenes
from .model.softgroup import Capacities, SceneBatch, SoftGroupNet
from .tools_impl.test_runner import InferenceRunner
from .train import TrainState, make_train_step
from .util.config import Config, load_config
from .util.optim import freeze

# the optimizer section of configs/softgroup/softgroup_scannet.yaml:
# {type: Adam, lr: 0.004}; eps is optax.adam's
TRAIN_LR, TRAIN_EPS = 0.004, 1e-8


def flagship_cfg(channels: int = 32, num_blocks: int = 7) -> Config:
    return Config(dict(
        channels=channels, num_blocks=num_blocks, semantic_classes=20,
        instance_classes=18, semantic_only=False, ignore_label=-100,
        with_coords=True, sem2ins_classes=[],
        grouping_cfg=dict(score_thr=0.2, radius=0.04, mean_active=300,
                          class_numpoint_mean=[-1.0] * 20, npoint_thr=50,
                          ignore_classes=[0, 1], pair_keys=False),
        instance_voxel_cfg=dict(scale=50, spatial_shape=20),
        train_cfg=dict(max_proposal_num=64, pos_iou_thr=0.5),
        test_cfg=dict(x4_split=False, cls_score_thr=0.001,
                      mask_score_thr=-0.5, min_npoint=100,
                      eval_tasks=['semantic', 'instance']),
    ))


def bench_capacities() -> Capacities:
    """Static capacities of the flagship bench (a 250k-point room scan)."""
    return Capacities(
        points=262144,
        voxels=(196608, 98304, 32768, 8192, 2048, 1024, 512),
        grouping_points=393216, proposals=256, proposal_entries=262144,
        instances=128, inst_voxels=(65536, 16384), grouping_cells=16384)


PLUS_YAML = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'configs',
    'softgroup_pp', 'softgroup++_scannet.yaml')


def plus_cfg() -> Config:
    """The model section of ``configs/softgroup_pp/softgroup++_scannet.yaml``
    (SoftGroup++ ScanNet: channels 32, 7 levels, 20 / 18 classes,
    ``pair_keys: False``, ``with_pyramid``, ``lvl_fusion``).  Its
    ``with_octree`` and ``pyramid_base_size`` are read by nothing."""
    return load_config(PLUS_YAML).model


def build_runner(net: SoftGroupNet, cfg: Config,
                 base_caps: Capacities = bench_capacities(),
                 device='cuda') -> InferenceRunner:
    """The inference runner of ``net`` (already on ``device``): per-scene
    capacities bucketed from ``base_caps``, ``cfg.num_blocks`` levels."""
    return InferenceRunner(net, cfg, base_caps, cfg.num_blocks,
                           device=device)


def build_net(cfg: Config, seed: int = 0, device='cuda',
              bf16: bool = True) -> SoftGroupNet:
    """The flagship net with a seeded init, in eval mode on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    net = SoftGroupNet(channels=cfg.channels, num_blocks=cfg.num_blocks,
                       semantic_classes=cfg.semantic_classes,
                       instance_classes=cfg.instance_classes,
                       semantic_only=cfg.semantic_only, bf16=bf16,
                       generator=gen)
    return net.to(device).eval()


def build_batch(scene, cfg: Config, caps: Capacities, scale: float = 50.0,
                device='cuda') -> SceneBatch:
    """One scene (xyz, rgb, semantic, instance) -> a padded SceneBatch."""
    data = collate_scenes([scene], scale=scale)
    return build_scene_batch(
        data['coords'], data['coords_float'], data['feats'],
        data['semantic_labels'], data['instance_labels'],
        data['pt_offset_labels'], data['instance_pointnum'],
        data['instance_cls'], data['spatial_shape'], caps,
        num_levels=cfg.num_blocks, ignore_label=cfg.ignore_label,
        with_coords=cfg.with_coords, device=device)


def infer(net: SoftGroupNet, batch: SceneBatch, cfg: Config,
          caps: Capacities) -> dict:
    """The ``test_forward`` outputs (tensors on the batch's device)."""
    return net.test_forward(batch, cfg, caps)


def train_cfg() -> Config:
    """The model section of ``configs/softgroup/softgroup_scannet.yaml``
    (the second ScanNet stage: the backbone is frozen by
    ``fixed_modules``)."""
    return Config(dict(
        channels=32, num_blocks=7, semantic_classes=20, instance_classes=18,
        sem2ins_classes=[], semantic_only=False, ignore_label=-100,
        with_coords=True,
        grouping_cfg=dict(
            pair_keys=False, score_thr=0.2, radius=0.04, mean_active=300,
            class_numpoint_mean=[
                -1.0, -1.0, 3917.0, 12056.0, 2303.0, 8331.0, 3948.0, 3166.0,
                5629.0, 11719.0, 1003.0, 3317.0, 4912.0, 10221.0, 3889.0,
                4136.0, 2120.0, 945.0, 3967.0, 2589.0],
            npoint_thr=0.05, ignore_classes=[0, 1]),
        instance_voxel_cfg=dict(scale=50, spatial_shape=20),
        train_cfg=dict(max_proposal_num=200, pos_iou_thr=0.5),
        test_cfg=dict(x4_split=False, cls_score_thr=0.001,
                      mask_score_thr=-0.5, min_npoint=100,
                      eval_tasks=['semantic', 'instance']),
        fixed_modules=['input_conv', 'unet', 'output_norm',
                       'semantic_linear', 'offset_linear'],
    ))


def train_capacities() -> Capacities:
    """Static capacities of a batch of four ~250k-point rooms (1M points;
    voxel caps sized for surface-sampled rooms, as
    ``tools/bench_train_batch4.py``)."""
    return Capacities(
        points=1048576,
        voxels=(851968, 425984, 131072, 65536, 16384, 8192, 4096),
        grouping_points=2097152, proposals=200, proposal_entries=524288,
        instances=384, inst_voxels=(131072, 32768), grouping_cells=131072)


def build_train_batch(scenes, cfg: Config, caps: Capacities,
                      scale: float = 50.0, device='cuda') -> SceneBatch:
    """Scenes [(xyz, rgb, semantic, instance), ...] -> one collated,
    padded SceneBatch (the batch index is the voxel coords' column 0)."""
    data = collate_scenes(list(scenes), scale=scale)
    return build_scene_batch(
        data['coords'], data['coords_float'], data['feats'],
        data['semantic_labels'], data['instance_labels'],
        data['pt_offset_labels'], data['instance_pointnum'],
        data['instance_cls'], data['spatial_shape'], caps,
        num_levels=cfg.num_blocks, ignore_label=cfg.ignore_label,
        with_coords=cfg.with_coords, device=device)


def build_train_state(net: SoftGroupNet, cfg: Config, caps: Capacities,
                      frozen_modules=()) -> TrainState:
    """Adam over the trainable parameters of ``net`` (the yaml's
    optimizer) and its train step;
    ``frozen_modules`` (e.g. ``cfg.fixed_modules``) keep ``requires_grad``
    False."""
    opt = torch.optim.Adam(freeze(net, frozen_modules), lr=TRAIN_LR,
                           eps=TRAIN_EPS)
    return TrainState(net, opt, make_train_step(net, cfg, caps, opt,
                                                frozen_modules))
