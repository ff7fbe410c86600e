"""The train CLI's data-parallel path on the CPU: ``train_cli.main(
['--device', 'cpu', '--num-devices', '2', ...])`` spawns two gloo ranks
on the tiny config of ``tests/test_cli.py``, checked against the
reference's loader and schedule (its own file so that it runs beside
``tests/test_torch_ddp.py`` under xdist).
"""

import json
import os

import numpy as np
import pytest
import torch

from softgroup_tpu_torch.tools_impl import train_cli
from softgroup_tpu_torch.util.config import load_config


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    """The tiny config of tests/test_cli.py over four 1200-point train
    scans (repeat 5: ten batches of two, five steps a rank) and one val
    scan; returns (root, config path)."""
    import yaml

    from test_cli import _make_config, _make_dataset
    root = tmp_path_factory.mktemp('ddp_cli')
    _make_dataset(str(root / 'data'), n_scans=4)
    path = _make_config(root, str(root / 'data'))
    cfg = load_config(path)
    cfg.data.train.repeat = 5
    cfg.data.train.seed = 3
    with open(path, 'w') as f:
        yaml.safe_dump(cfg.to_dict(), f)
    return root, path


def test_train_cli_two_ranks(tiny):
    """(f) ``main(--device cpu --num-devices 2)`` for two epochs, then
    ``--resume --epochs 3``: ``len // 2`` steps an epoch, rank 0 on the
    reference loader's batches 2k, the schedule at those counts, equal
    replicas at the end, one writer of the log, the scalars and the
    checkpoints, and the resumed run continuing from epoch 2's
    checkpoint."""
    from softgroup_tpu.data import build_dataloader as jax_build_dataloader
    from softgroup_tpu.data import build_dataset as jax_build_dataset

    from softgroup_tpu_torch.util.optim import cosine_after_step_schedule
    root, path = tiny
    work = root / 'work'
    first = {}
    train_cli.main([path, '--device', 'cpu', '--num-devices', '2',
                    '--epochs', '2'], stats=first)
    assert first['world'] == 2 and first['steps_per_epoch'] == 5
    assert first['replica_max_diff'] == 0.0
    sched = cosine_after_step_schedule(0.004, 1, 2, 5)
    assert [s['update'] for s in first['steps']] == list(range(10))
    assert [s['lr'] for s in first['steps']] == [sched(k) for k in range(10)]
    cfg = load_config(path)
    ref = jax_build_dataloader(jax_build_dataset(cfg.data.train),
                               batch_size=2, training=True)
    for epoch in (1, 2):
        ref.set_epoch(epoch)
        want = [b['scan_ids'] for b in list(ref)[0::2]]
        got = [s['scan_ids'] for s in first['steps'] if s['epoch'] == epoch]
        assert got == want, epoch
    assert all(np.isfinite(v) for s in first['steps']
               for v in s['logs'].values())

    second = {}
    train_cli.main([path, '--device', 'cpu', '--num-devices', '2',
                    '--epochs', '3', '--resume'], stats=second)
    assert second['start_epoch'] == 3 and second['replica_max_diff'] == 0.0
    assert [s['update'] for s in second['steps']] == list(range(10, 15))

    kept = sorted(os.listdir(work / 'ckpt'))
    assert kept == ['epoch_1', 'epoch_2', 'epoch_3', 'latest']
    saved = torch.load(work / 'ckpt' / 'epoch_3', weights_only=True)
    assert saved['epoch'] == 3 and saved['updates'] == 15
    lines = [ln.split(' - INFO - ', 1)[1]
             for ln in (work / 'train.log').read_text().splitlines()
             if ' - INFO - ' in ln]
    assert lines.count('training done') == 2
    assert lines.count('resumed at epoch 3') == 1
    assert sum(ln.startswith('config: ') and 'ranks: 2 (gloo)' in ln
               for ln in lines) == 2
    with open(work / 'scalars.jsonl') as f:
        recs = [json.loads(line) for line in f]
    for epoch in (1, 2, 3):
        keys = [r['key'] for r in recs if r['step'] == epoch]
        assert len(keys) == len(set(keys)) and 'train/lr' in keys, epoch
        assert ('val/AP' in keys) == (epoch < 3), epoch
