"""ctypes binding and build of the native grid loader.

This package's copy of ``meshdiffusion_tpu/native/grid_loader.py``. The C++
library (``grid_loader.cpp`` beside this file) does the hot path of the
training data feed (npy decode, SDF sign-normalize, deform jitter, mask
multiply, pad, channels-last batch assembly; reference
shapenet_dmtet_dataset.py:32-54) on a persistent thread pool that writes
straight into a reusable numpy batch buffer.

``g++`` builds it at first use into ``meshdiffusion_tpu_torch/_build/``
(git-ignored), under a name keyed on a hash of the source and flags, never
beside the source. A failed build logs a warning and returns None; callers
check :func:`native_available` and use the Python
``data.dataset.ShapeNetDMTetDataset`` otherwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'grid_loader.cpp')
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), '_build')
_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17', '-pthread']
_lock = threading.Lock()
_lib_handle = None


def library_path() -> str:
    h = hashlib.sha256(' '.join(_FLAGS).encode())
    with open(_SRC, 'rb') as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f'libgrid_loader_{h.hexdigest()[:16]}.so')


def build_native() -> Optional[str]:
    """Compile grid_loader.cpp unless the library for its hash exists;
    returns its path, or None (with a warning) when g++ fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(['g++'] + _FLAGS + [_SRC, '-o', tmp], check=True, capture_output=True,
                       text=True)
        os.replace(tmp, so)
        return so
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        logger.warning('native grid loader build failed: %s', getattr(e, 'stderr', e))
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_lib():
    global _lib_handle
    with _lock:
        if _lib_handle is not None:
            return _lib_handle
        path = build_native()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.grid_loader_create.restype = ctypes.c_void_p
        lib.grid_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
        lib.grid_loader_fill.restype = ctypes.c_int
        lib.grid_loader_fill.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float)]
        lib.grid_loader_last_error.restype = ctypes.c_char_p
        lib.grid_loader_last_error.argtypes = [ctypes.c_void_p]
        lib.grid_loader_destroy.restype = None
        lib.grid_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib_handle = lib
        return lib


def native_available() -> bool:
    return _load_lib() is not None


class NativeGridLoader:
    """Shuffling, epoch-wrapping batch iterator backed by the C++ pool; in
    the place of ``data.dataset.GridLoader`` for .npy datasets: yields
    (B, R, R, R, 4) float32 channels-last batches forever."""

    def __init__(self, paths: Sequence[str], grid_mask: np.ndarray,
                 batch_size: int, aug: bool = True,
                 normalize_sdf: bool = True, num_workers: int = 4,
                 seed: int = 0):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError('native grid loader unavailable (g++ build failed)')
        bad = [p for p in paths if not p.endswith('.npy')]
        if bad:
            raise ValueError(f'.npy only; got {bad[:3]}')
        self._lib = lib
        self.paths = list(paths)
        self.batch_size = batch_size
        gm = np.ascontiguousarray(np.asarray(grid_mask, np.float32).reshape(-1))
        self.resolution = int(round(len(gm) ** (1 / 3)))
        if self.resolution ** 3 != len(gm):
            raise ValueError(f'the grid mask must hold R^3 values, got {len(gm)}')
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in self.paths])
        self._handle = lib.grid_loader_create(
            arr, len(paths), gm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.resolution, int(aug), int(normalize_sdf),
            ctypes.c_uint64(seed), num_workers)
        self._rng = np.random.default_rng(seed)
        self._perm: List[int] = []
        R = self.resolution
        self._buf = np.empty((batch_size, R, R, R, 4), np.float32)

    def _next_indices(self) -> np.ndarray:
        while len(self._perm) < self.batch_size:
            self._perm.extend(self._rng.permutation(len(self.paths)).tolist())
        idx = self._perm[:self.batch_size]
        del self._perm[:self.batch_size]
        return np.asarray(idx, np.int64)

    def load_indices(self, indices: np.ndarray) -> np.ndarray:
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        if len(idx) > self.batch_size or (len(idx) and not 0 <= idx.min() <= idx.max()
                                          < len(self.paths)):
            raise ValueError(f'indices {idx} outside the {len(self.paths)} paths or over '
                             f'the batch of {self.batch_size}')
        rc = self._lib.grid_loader_fill(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            err = self._lib.grid_loader_last_error(self._handle)
            raise RuntimeError(f'native loader: {err.decode()}')
        return self._buf[:len(idx)].copy()

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return self.load_indices(self._next_indices())

    def close(self):
        if self._handle:
            self._lib.grid_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
