"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc, by hand, into its own shared library
with a plain C interface, loaded with ctypes: no PyTorch headers, so a
build takes seconds. Libraries land in ``skypilot_tpu_torch/_build/``
(git-ignored) under a name keyed by a hash of the source and the
flags, so a changed source rebuilds and an unchanged one loads as is.
:func:`build_all` starts one nvcc per missing library, all at once.

Nothing is compiled at import time: a kernel builds at its first launch
(or at an explicit ``build_all()``), so the CPU tests import every
module without nvcc.

Each :class:`Kernel` keeps ``launches``, a plain int that its
``launch`` bumps once per kernel launch and nowhere else, so a run can
prove which kernels its main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = ('-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC')

_CTYPES = {'p': ctypes.c_void_p, 'i': ctypes.c_int, 'f': ctypes.c_float}
_lock = threading.Lock()
_KERNELS: Dict[str, 'Kernel'] = {}


def nvcc_path() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels build only on '
                           'a machine with the CUDA toolkit')
    return path


def _lib_path(source: str) -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        # Headers are shared by every source: hash them all in.
        if name == source or name.endswith('.cuh'):
            with open(os.path.join(CSRC, name), 'rb') as f:
                h.update(name.encode() + b'\0' + f.read())
    h.update(' '.join(ARCH_FLAGS + NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f'lib{stem}-{h.hexdigest()[:16]}.so')


def _start_build(source: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, '-Xptxas', '-v',
           '-o', tmp, os.path.join(CSRC, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp, proc.out, proc.source = tmp, out, source
    return proc


def _finish_build(proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {proc.source} '
                           f'(rc={proc.returncode}):\n{log}')
    os.replace(proc.tmp, proc.out)
    return log


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Build every registered kernel's library that is missing, one nvcc
    per source started together; load them all. Returns the compiler's
    log (registers, shared memory, spills) per kernel name."""
    with _lock:
        kernels = [k for n, k in _KERNELS.items()
                   if names is None or n in names]
        procs = {k.name: _start_build(k.source, _lib_path(k.source))
                 for k in kernels if not os.path.exists(_lib_path(k.source))}
        logs = {name: _finish_build(p) for name, p in procs.items()}
        for k in kernels:
            k._load()
    return logs


class Kernel:
    """One C entry point of one csrc/ source. ``argtypes`` is a string
    of ctypes codes: 'p' pointer (and stream), 'i' int, 'f' float. The
    entry point returns cudaGetLastError(); non-zero raises."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence[str]):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = [_CTYPES[a] for a in argtypes]
        self.launches = 0
        self._fn = None
        _KERNELS[name] = self

    def _load(self) -> None:
        if self._fn is not None:
            return
        lib = ctypes.CDLL(_lib_path(self.source))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._lib, self._fn = lib, fn

    def launch(self, *args) -> None:
        if self._fn is None:
            build_all([self.name])
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f'kernel {self.name} launch failed: CUDA '
                               f'error {rc}')
        self.launches += 1


def kernels() -> Dict[str, Kernel]:
    """Every registered kernel by name (registration happens when its
    ops module is imported)."""
    return dict(_KERNELS)


def reset_launches() -> None:
    for k in _KERNELS.values():
        k.launches = 0
