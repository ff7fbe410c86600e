"""The import guard compares whole top-level names; the benchmark loads no
JAX module, the reference nothing of the program; without a card, or
without the program beside it, a run prints no result and fails."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

from portbench import guard, spec


@pytest.mark.parametrize('modules,found', [
    (['softgroup_tpu_torch', 'softgroup_tpu_torch.ops'], []),
    (['softgroup_tpu', 'numpy'], ['softgroup_tpu']),
    (['softgroup_tpu.model.softgroup'], ['softgroup_tpu']),
    (['jaxlib.xla_client', 'jaxtyping'], ['jaxlib']),
    (['jax', 'flax.linen', 'softgroup_tpux'], ['flax', 'jax']),
])
def test_names_are_compared_whole(modules, found):
    assert guard.forbidden_modules(modules) == found


def _python(code: str, cwd: str = spec.ROOT, env=None):
    return subprocess.run([sys.executable, '-c', code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_benchmark_modules_load_no_jax():
    code = ('import sys, importlib, pkgutil, portbench, portbench.loops, '
            'portbench.reference\n'
            'for pkg in (portbench, portbench.loops, portbench.reference):\n'
            '    for m in pkgutil.iter_modules(pkg.__path__):\n'
            '        if m.name != "tests":\n'
            '            importlib.import_module(pkg.__name__ + "." + m.name)\n'
            'from portbench import guard, spec\n'
            'for m in spec.benchmark()["per_layer"]:\n'
            '    spec.metric_reader(m["name"])\n'
            'import softgroup_tpu_torch.tools_impl.train_cli, '
            'softgroup_tpu_torch.tools_impl.test_runner\n'
            'print(guard.forbidden_modules())')
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(spec.HERE, 'reference')
    for name in os.listdir(ref_dir):
        if name.endswith('.py'):
            with open(os.path.join(ref_dir, name)) as f:
                assert 'softgroup_tpu' not in f.read(), name
    code = ('import sys, portbench.reference.sparse_unet, '
            'portbench.reference.softgroup_serve\n'
            'print(sorted({m.split(".")[0] for m in sys.modules} & '
            '{"softgroup_tpu_torch", "softgroup_tpu", "jax"}))')
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run(
        [sys.executable, '-m', 'portbench.run', '--workload',
         'scannet_train_stage1', '--seed', '1', '--seconds', '1',
         '--trace', '0'], cwd=spec.ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ''


def test_benchmark_alone_fails(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder: no program, no result."""
    shutil.copy(os.path.join(spec.ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = subprocess.run(
        [sys.executable, '-m', 'portbench.run', '--workload',
         'scannet_train_stage1', '--seed', '1', '--seconds', '1',
         '--trace', '0'], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=''))
    assert out.returncode != 0
    assert out.stdout.strip() == ''
