"""The port's native host geometry (``softgroup_tpu_torch/ops/native.py`` over
``csrc/hostops.cpp``) against its own numpy builders and the reference's
numpy builders: bit-identical arrays on random coordinates, the whole
pyramid both ways, and a failed build that raises instead of falling back.
"""

import os

import numpy as np
import pytest

from softgroup_tpu.ops.rulebook import build_downsample_np as jax_downsample
from softgroup_tpu.ops.rulebook import build_subm_rules_np as jax_subm
from softgroup_tpu.ops.voxelize import voxelize_np as jax_voxelize
from softgroup_tpu_torch.ops import native
from softgroup_tpu_torch.ops.geometry import build_pyramid_np, host_geometry
from softgroup_tpu_torch.ops.rulebook import (build_downsample_np,
                                              build_subm_rules_np)
from softgroup_tpu_torch.ops.voxelize import voxelize_np

SEEDS = [0, 1, 2]


def random_coords(seed, n, extent=24, batch=3):
    rng = np.random.RandomState(seed)
    return np.concatenate(
        [rng.randint(0, batch, size=(n, 1)),
         rng.randint(0, extent, size=(n, 3))], axis=1).astype(np.int32)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('seed', SEEDS)
def test_voxelize_matches_numpy(seed):
    coords = random_coords(seed, 5000)
    vc, p2v, m = native.voxelize_native(coords)
    for ref in (voxelize_np(coords), jax_voxelize(coords)):
        assert m == len(ref[0])
        _equal(vc, ref[0])
        _equal(p2v, ref[1])


@pytest.mark.parametrize('seed', SEEDS)
def test_subm_rules_match_numpy(seed):
    vc, _, _ = voxelize_np(random_coords(seed, 2000))
    dims = np.array([24, 20, 24])   # a plane past 20 leaves the grid
    got = native.subm_rules_native(vc, dims)
    _equal(got, build_subm_rules_np(vc, dims))
    _equal(got, jax_subm(vc, dims))
    assert (got == -1).any() and (got >= 0).sum() > len(vc)


@pytest.mark.parametrize('seed', SEEDS)
def test_downsample_matches_numpy(seed):
    vc, _, _ = voxelize_np(random_coords(seed, 3000))
    got = native.downsample_native(vc)
    for ref in (build_downsample_np(vc), jax_downsample(vc)):
        for a, b in zip(got, ref):
            _equal(a, b)


@pytest.mark.parametrize('seed', SEEDS)
def test_subm_rules_any_voxel_order(seed):
    """Voxel rows in any order, and coordinates past the packed key's
    fields (negative ones): the native merge join searches a query that
    falls below the last one, and still equals the numpy builders."""
    coords = random_coords(seed, 2000)
    coords[::97, 1:] -= 2
    vc, _, _ = voxelize_np(coords)
    vc = vc[np.random.RandomState(seed).permutation(len(vc))]
    dims = np.array([24, 20, 24])
    got = native.subm_rules_native(vc, dims)
    _equal(got, build_subm_rules_np(vc, dims))
    _equal(got, jax_subm(vc, dims))
    assert (got >= 0).sum() > len(vc)


@pytest.mark.parametrize('seed', SEEDS)
def test_voxelize_negative_coords(seed):
    coords = random_coords(seed, 3000)
    coords[::53, 1:] -= 3
    vc, p2v, m = native.voxelize_native(coords)
    ref = voxelize_np(coords)
    assert m == len(ref[0])
    _equal(vc, ref[0])
    _equal(p2v, ref[1])


def test_padded_geometry_rejects_overflow():
    geom = host_geometry(random_coords(0, 500), np.array([24, 24, 24]), 3)
    caps = list(geom.counts)
    caps[1] -= 1
    with pytest.raises(ValueError, match='level 1'):
        geom.padded(caps)


@pytest.mark.parametrize('pad', [None, 100], ids=['exact', 'padded'])
def test_build_pyramid_native_matches_numpy(pad):
    coords = random_coords(3, 6000, extent=40, batch=2)
    dims = np.array([40, 40, 40])
    caps = None if pad is None else [
        len(lv.vox_coords) + pad
        for lv in build_pyramid_np(coords, dims, 4, native=False).levels]
    a = build_pyramid_np(coords, dims, 4, caps)
    b = build_pyramid_np(coords, dims, 4, caps, native=False)
    _equal(a.p2v.numpy(), b.p2v.numpy())
    _equal(a.point_valid.numpy(), b.point_valid.numpy())
    for la, lb in zip(a.levels, b.levels):
        for f in ('vox_coords', 'vox_valid', 'subm_rules', 'down_rules',
                  'parent_idx', 'child_tap', 'dims'):
            x, y = getattr(la, f), getattr(lb, f)
            assert (x is None) == (y is None), f
            if x is not None:
                _equal(x.numpy(), y.numpy())


@pytest.mark.parametrize('cxx', ['missing', 'failing'])
def test_failed_build_raises(tmp_path, monkeypatch, cxx):
    """A missing compiler, or one that fails, raises from the builders and
    from ``build_pyramid_np``; nothing is loaded or left behind."""
    fake = tmp_path / 'no-such-compiler' if cxx == 'missing' else 'false'
    monkeypatch.setenv('CXX', str(fake))
    monkeypatch.setattr(native, 'BUILD', str(tmp_path / 'build'))
    monkeypatch.setattr(native, '_lib', None)
    coords = random_coords(0, 100)
    with pytest.raises(RuntimeError, match='hostops.cpp'):
        native.voxelize_native(coords)
    with pytest.raises(RuntimeError, match='hostops.cpp'):
        build_pyramid_np(coords, np.array([24, 24, 24]), 2)
    assert native._lib is None
    assert not os.listdir(tmp_path / 'build')


def test_library_is_portable_and_keyed_on_its_source(tmp_path):
    """The library is built without host-specific code generation (the
    build directory may be copied to another machine) under a name keyed
    on a digest of the source and flags, outside the reference's tree."""
    assert not any(f.startswith('-march') or f.startswith('-mtune')
                   for f in native.CXX_FLAGS)
    path = native.lib_path()
    assert os.path.dirname(path) == native.BUILD
    assert 'softgroup_tpu_torch' in path and 'libhostops' not in path
    assert native.lib_path(str(tmp_path)) == str(
        tmp_path / os.path.basename(path))


def test_native_rejects_malformed_shapes():
    """The C code reads 4 ints a row and 3 dims: other shapes raise before
    a pointer is passed."""
    with pytest.raises(ValueError, match=r'\(N, 4\)'):
        native.voxelize_native(np.zeros((10, 3), np.int32))
    with pytest.raises(ValueError, match='dims'):
        native.subm_rules_native(np.zeros((10, 4), np.int32),
                                 np.array([4, 4]))
    with pytest.raises(ValueError, match=r'\(N, 4\)'):
        native.downsample_native(np.zeros((10,), np.int32))
