"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use with nvcc for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, and loaded with ctypes.  Libraries land in
``softgroup_tpu_torch/build/`` under a name that carries a hash of the
source and of the shared ``csrc/*.cuh`` headers, so an edited source or
header is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU tests import every module.

Every C entry point launches on the stream it is given (the wrapper passes
PyTorch's current stream, ``stream``), allocates nothing, and returns
``cudaGetLastError()``; ``check`` raises when that is not 0.  ``entry``
hands a wrapper its C function without the build lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'csrc')
BUILD = os.path.join(os.path.dirname(CSRC), 'build')
SOURCES = ('conv', 'gather', 'join', 'norm')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-lineinfo')

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# C signatures of the entry points, by library
SIGNATURES = {
    'conv': {
        'sg_rulebook_conv': (_P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _I, _I,
                             _P, _P),
        'sg_keyed_conv': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                          _I, _I, _P, _P),
        'sg_conv_dw': (_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                       _P, _P),
    },
    'gather': {'sg_row_gather': (_P, _P, _I, _I, _I, _LL, _P, _P),
               'sg_segment_sum': (_P, _P, _LL, _I, _I, _I, _I, _I, _P, _P,
                                  _P, _P)},
    'join': {'sg_cell_join': (_P, _P, _P, _P, _P, _I, _F, _I, _P, _P, _P),
             'sg_cell_join64': (_P, _P, _P, _P, _P, _I, _F, _I, _P, _P,
                                _P),
             'sg_rules_join': (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P)},
    'norm': {'sg_bn_forward': (_P, _P, _P, _P, _P, _P, _P, _F, _F, _I, _P,
                               _P, _P),
             'sg_bn_backward': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I,
                                _P, _P, _P)},
}

_libs: dict = {}
_fns: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    if not os.path.isfile(path):
        raise RuntimeError('nvcc not found (PATH, CUDA_HOME, '
                           '/usr/local/cuda/bin): the CUDA kernels cannot '
                           'be built')
    return path


def _lib_path(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f'{name}.cu')
    digest = hashlib.sha1(' '.join(NVCC_FLAGS).encode())
    # the source and every shared header it may include
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith('.cuh'))
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, 'rb') as f:
            digest.update(f.read())
    return src, os.path.join(BUILD, f'{name}-{digest.hexdigest()[:12]}.so')


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process or None, tmp path, final path)."""
    src, out = _lib_path(name)
    if os.path.isfile(out):
        return None, None, out
    os.makedirs(BUILD, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, '-o', tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish_build(name, proc, tmp, out) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for csrc/{name}.cu '
                           f'(rc={proc.returncode}):\n{log}')
    os.replace(tmp, out)


def build_all(names=SOURCES) -> None:
    """Compile every kernel source at once (one nvcc per source, all
    started together), then load them."""
    with _lock:
        started = [(n, *_start_build(n)) for n in names if n not in _libs]
        try:
            for args in started:
                _finish_build(*args)
        finally:
            for n, proc, _, _ in started:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
    for n in names:
        lib(n)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed)."""
    with _lock:
        if name not in _libs:
            proc, tmp, out = _start_build(name)
            _finish_build(name, proc, tmp, out)
            handle = ctypes.CDLL(out)
            for fn, argtypes in SIGNATURES[name].items():
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = ctypes.c_int
            _libs[name] = handle
        return _libs[name]


def entry(name: str, fn: str):
    """The C entry point ``fn`` of library ``name``, looked up (and the
    library built) once; later calls take no lock."""
    f = _fns.get(fn)
    if f is None:
        f = _fns[fn] = getattr(lib(name), fn)
    return f


# PyTorch's own raw getter of the current stream (the one its generated
# kernels launch with): a plain int, where ``torch.cuda.current_stream()``
# builds a Stream object on every call
_raw_stream = getattr(torch._C, '_cuda_getCurrentRawStream', None)


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the integer handle the C
    entry points take."""
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA error {rc} at launch')


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != 'cuda':
            raise ValueError(f'{what}: tensors must share one CUDA device, '
                             f'got {t.device} and {dev}')
        if not t.is_contiguous():
            raise ValueError(f'{what}: tensors must be contiguous')
