"""ctypes bindings to the native host-geometry library (``csrc/hostops.cpp``):
voxelization, the 3^3 submanifold rulebook and the k2s2 downsample maps,
bit-identical to the numpy builders of ``voxelize.py`` / ``rulebook.py``.

The library is compiled at first use with the C++ compiler named by
``CXX`` (default ``g++``) into ``softgroup_tpu_torch/build/``, under a name
that carries a digest of the source and the flags, through a temp file
renamed into place (concurrent builders never load a half-written file).
It is built without ``-march=native``: the build directory may be copied
to another machine, and a library tuned for one CPU can stop on an
illegal instruction on another.  A failed build raises; nothing falls back
to numpy behind the caller's back (``geometry.build_pyramid_np`` takes
the numpy builders only when asked, ``native=False``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'csrc', 'hostops.cpp')
BUILD = os.path.join(os.path.dirname(os.path.dirname(SRC)), 'build')
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_P, _LL = ctypes.c_void_p, ctypes.c_int64
SIGNATURES = {
    'sg_voxelize': (_LL, (_P, _LL, _P, _P, _LL)),
    'sg_subm_rules': (None, (_P, _LL, _P, _P)),
    'sg_downsample': (_LL, (_P, _LL, _P, _P, _P, _P, _LL)),
}

_lib = None
_lock = threading.Lock()


def lib_path(build_dir: str | None = None) -> str:
    digest = hashlib.sha1(' '.join(CXX_FLAGS).encode())
    with open(SRC, 'rb') as f:
        digest.update(f.read())
    return os.path.join(build_dir or BUILD,
                        f'hostops-{digest.hexdigest()[:12]}.so')


def build(build_dir: str | None = None) -> str:
    """The library's path, compiled first if it is not there; raises
    RuntimeError when the compiler is missing or fails."""
    out = lib_path(build_dir)
    if os.path.isfile(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cxx = os.environ.get('CXX') or 'g++'
    tmp = f'{out}.{os.getpid()}.tmp'
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, SRC, '-o', tmp],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f'cannot build csrc/hostops.cpp: {cxx}: {e}') \
            from e
    if proc.returncode != 0:
        raise RuntimeError(f'{cxx} failed for csrc/hostops.cpp '
                           f'(rc={proc.returncode}):\n{proc.stderr}')
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for fn, (restype, argtypes) in SIGNATURES.items():
                getattr(handle, fn).restype = restype
                getattr(handle, fn).argtypes = argtypes
            _lib = handle
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _coords(a: np.ndarray, what: str) -> np.ndarray:
    """(N, 4) int32 C-contiguous (b, x, y, z) rows, checked before the C
    code reads 4 ints a row."""
    a = np.ascontiguousarray(a, np.int32)
    if a.ndim != 2 or a.shape[1] != 4:
        raise ValueError(f'{what}: expected (N, 4) coords, got {a.shape}')
    return a


def voxelize_native(coords: np.ndarray):
    """(N, 4) int coords -> (vox_coords (M, 4) int32 in sorted key order,
    p2v (N,) int32, M): ``voxelize_np``'s first two outputs."""
    coords = _coords(coords, 'voxelize_native')
    n = len(coords)
    p2v = np.empty(n, np.int32)
    vox = np.zeros((n, 4), np.int32)
    m = lib().sg_voxelize(_ptr(coords), n, _ptr(p2v), _ptr(vox), n)
    return vox[:m], p2v, m


def subm_rules_native(vox_coords: np.ndarray, dims: np.ndarray) -> np.ndarray:
    """(27, M) int32 gather table, -1 for missing neighbours
    (``build_subm_rules_np``)."""
    vox = _coords(vox_coords, 'subm_rules_native')
    m = len(vox)
    dims = np.ascontiguousarray(dims, np.int32)
    if dims.shape != (3,):
        raise ValueError(f'subm_rules_native: dims must be (3,), got '
                         f'{dims.shape}')
    rules = np.empty((27, m), np.int32)
    lib().sg_subm_rules(_ptr(vox), m, _ptr(dims), _ptr(rules))
    return rules


def downsample_native(vox_coords: np.ndarray):
    """(out_coords (C, 4), down_rules (8, C), parent_idx (M,), child_tap
    (M,)), all int32 (``build_downsample_np``)."""
    vox = _coords(vox_coords, 'downsample_native')
    m = len(vox)
    out = np.zeros((m, 4), np.int32)
    down = np.empty((8, m), np.int32)
    parent = np.empty(m, np.int32)
    tap = np.empty(m, np.int32)
    c = lib().sg_downsample(_ptr(vox), m, _ptr(out), _ptr(down),
                            _ptr(parent), _ptr(tap), m)
    return out[:c], np.ascontiguousarray(down[:, :c]), parent, tap
