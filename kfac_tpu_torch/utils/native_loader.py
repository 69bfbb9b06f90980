"""ctypes binding of the native prefetching batch loader (counterpart of
``kfac_tpu/utils/native_loader.py``).

``kfac_tpu_torch/csrc/loader.cpp`` is built with ``g++`` at first use into
``build/native/`` at the repository root (named by a hash of the source
and the flags), and :class:`PrefetchLoader` iterates the shuffled (data,
labels) batches its background C++ thread assembles, so host batch work
overlaps the card's step. The C functions and their signatures are the
JAX package's.

There is no fallback: a build that fails raises
:class:`NativeLoaderUnavailable` (the JAX examples print a line and go on
with Python batches; a port script asked for ``--native-loader`` stops).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'loader.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'
FLAGS = ('-O2', '-shared', '-fPIC', '-std=c++17', '-pthread')

_lib = None
_lib_lock = threading.Lock()


class NativeLoaderUnavailable(RuntimeError):
    """The native loader could not be built or loaded."""


def library_path() -> Path:
    """The library's path, keyed by the source's content and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes() + ' '.join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'libkfacloader-{digest}.so'


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    try:
        subprocess.run(['g++', *FLAGS, str(SOURCE), '-o', str(tmp)], check=True,
                       capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise NativeLoaderUnavailable(f'g++ not found: {exc}') from exc
    except subprocess.CalledProcessError as exc:
        raise NativeLoaderUnavailable(f'g++ failed:\n{exc.stderr}') from exc
    os.replace(tmp, out)


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
        ]
        lib.loader_create_aug.restype = ctypes.c_void_p
        lib.loader_create_aug.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int64,
        ]
        lib.loader_next.restype = ctypes.c_int64
        lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.loader_release.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.loader_batches_per_epoch.restype = ctypes.c_int64
        lib.loader_batches_per_epoch.argtypes = [ctypes.c_void_p]
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class PrefetchLoader:
    """Shuffled batches assembled by the native worker thread.

    Args:
        data: (n, ...) float32 array; a C-contiguous float32 memmap is read
            in place (no copy), the on-disk ImageNet layout.
        labels: (n,) int32 array.
        batch_size: samples a batch.
        n_ring: prefetch depth (ring buffer slots).
        seed: shuffle seed.
        drop_last: drop each epoch's final ragged batch.
        augment: ``{'pad': 4, 'flip': True}`` crops and flips (H, W, C)
            samples in the worker (RandomCrop(padding=pad) and
            RandomHorizontalFlip).
        start_epoch: the shuffle and augmentation streams are advanced past
            the epochs before it, so a resumed run sees the batches the
            uninterrupted one saw.
    """

    def __init__(
        self,
        data: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        n_ring: int = 3,
        seed: int = 0,
        drop_last: bool = True,
        augment: dict | None = None,
        start_epoch: int = 0,
    ) -> None:
        self._handle = None
        lib = _load_lib()
        self._lib = lib
        self.data = np.ascontiguousarray(data, dtype=np.float32)
        self.labels = np.ascontiguousarray(labels, dtype=np.int32)
        n = len(self.data)
        if drop_last and n < batch_size:
            raise ValueError(f'{n} samples yield zero batches of size {batch_size} with drop_last=True')
        if len(self.labels) != n:
            raise ValueError(f'{n} samples but {len(self.labels)} labels')
        self.sample_shape = self.data.shape[1:]
        sample_elems = int(np.prod(self.sample_shape)) if self.sample_shape else 1
        self.batch_size = batch_size
        self._ring_data = np.empty((n_ring, batch_size, sample_elems), dtype=np.float32)
        self._ring_labels = np.empty((n_ring, batch_size), dtype=np.int32)
        if augment is not None and len(self.sample_shape) != 3:
            raise ValueError(f'augment needs (H, W, C) samples, got {self.sample_shape}')
        h, w, c = self.sample_shape if augment is not None else (0, 0, 0)
        self._handle = lib.loader_create_aug(
            self.data.ctypes.data_as(ctypes.c_void_p),
            self.labels.ctypes.data_as(ctypes.c_void_p),
            n, sample_elems, batch_size, n_ring,
            self._ring_data.ctypes.data_as(ctypes.c_void_p),
            self._ring_labels.ctypes.data_as(ctypes.c_void_p),
            seed, int(drop_last),
            h, w, c,
            int(augment.get('pad', 4)) if augment is not None else 0,
            int(bool(augment.get('flip', True))) if augment is not None else 0,
            int(start_epoch),
        )
        self.batches_per_epoch = int(lib.loader_batches_per_epoch(self._handle))
        self._next_epoch = int(start_epoch)  # the epoch the next epoch_batches() serves

    def __iter__(self):
        return self.epoch_batches()

    def epoch_batches(self):
        """One epoch of ``(data, labels)`` batches (copies). The producer
        runs on across epochs; slots of an epoch a previous consumer left
        early are drained here, so every call starts at an epoch
        boundary."""
        target = self._next_epoch
        self._next_epoch = target + 1
        yielded = 0
        while yielded < self.batches_per_epoch:
            epoch = ctypes.c_int64()
            slot = self._lib.loader_next(self._handle, ctypes.byref(epoch))
            if slot < 0:
                return
            if epoch.value < target:  # left over from an abandoned epoch
                self._lib.loader_release(self._handle, slot)
                continue
            x = self._ring_data[slot].reshape((self.batch_size,) + self.sample_shape).copy()
            y = self._ring_labels[slot].copy()
            self._lib.loader_release(self._handle, slot)
            yield x, y
            yielded += 1

    def close(self) -> None:
        """Stop and join the worker thread."""
        if self._handle is not None:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> 'PrefetchLoader':
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        if getattr(self, '_handle', None) is not None:
            self.close()
