"""ShapeNet DMTet 3D-grid dataset with a prefetching host loader.

This package's copy of ``meshdiffusion_tpu/data/dataset.py`` (numpy only;
reference ``lib/dataset/shapenet_dmtet_dataset.py``: a json list of grid
files, the train-split filter by trailing filename id, the sign-normalized
SDF channel, the global deform jitter, the grid-mask multiply, the
63^3 -> 64^3 zero pad):

* batches are assembled on the host channels-last, (B, R, R, R, 4), the
  U-Net's layout;
* a thread pool decodes and augments while the card computes, and
  ``GridLoader`` keeps batches in flight (reference trainer.py:72-75);
* legacy ``.pt`` grids are read with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import queue
import threading
from typing import Iterator, List, Optional

import numpy as np
import torch


def _load_grid(path: str) -> np.ndarray:
    """Load one (4, R, R, R) grid from .npy or torch .pt."""
    if path.endswith('.npy'):
        return np.asarray(np.load(path), np.float32)
    if path.endswith('.pt'):
        return torch.load(path, map_location='cpu', weights_only=True).to(torch.float32).numpy()
    raise ValueError(f'unknown grid extension: {path}')


class ShapeNetDMTetDataset:
    """Maps index -> augmented (R, R, R, 4) channels-last sample."""

    def __init__(self, meta_path: str, grid_mask: np.ndarray,
                 deform_scale: float = 1.0, aug: bool = False,
                 filter_meta_path: Optional[str] = None,
                 normalize_sdf: bool = True, extension: str = 'npy',
                 seed: int = 0):
        with open(meta_path) as f:
            self.fpath_list: List[str] = json.load(f)
        self.deform_scale = deform_scale
        self.normalize_sdf = normalize_sdf
        self.aug = aug
        self.extension = extension
        assert extension in ('pt', 'npy')
        # grid_mask: (R, R, R) or (..., R, R, R)
        gm = np.asarray(grid_mask, np.float32)
        self.grid_mask = gm.reshape(gm.shape[-3:])
        self.resolution = self.grid_mask.shape[-1]
        self._rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()

        if filter_meta_path:
            with open(filter_meta_path) as f:
                filter_ids = set(json.load(f))
            ext_len = len(extension) + 1

            def trailing_id(p: str) -> int:
                return int(p.rstrip().split('_')[-1][:-ext_len])

            self.fpath_list = [p for p in self.fpath_list
                               if trailing_id(p) in filter_ids]

    def __len__(self) -> int:
        return len(self.fpath_list)

    def draw_jitter(self) -> np.ndarray:
        """The next sample's deform jitter, uniform(-0.5, 0.5) a channel."""
        with self._rng_lock:
            return self._rng.random(3, dtype=np.float32) - 0.5

    def __getitem__(self, idx: int, jitter: Optional[np.ndarray] = None) -> np.ndarray:
        """Sample ``idx``, augmented with ``jitter`` (drawn here when None)."""
        datum = _load_grid(self.fpath_list[idx])       # (4, r, r, r)
        r = datum.shape[-1]
        if self.normalize_sdf:
            sign = np.sign(datum[:1])
            sign[sign == 0] = 1.0
            datum[:1] = sign
        if self.aug:
            # global +-0.005 deform jitter on nonempty cells
            # (reference shapenet_dmtet_dataset.py:42-44)
            nonempty = (np.abs(datum[1:]).sum(axis=0, keepdims=True) != 0)
            if jitter is None:
                jitter = self.draw_jitter()
            datum[1:] = datum[1:] + (jitter[:, None, None, None] * 0.01
                                     * nonempty / (r / self.resolution))
            datum = datum * self.grid_mask[None, :r, :r, :r]
        if r < self.resolution:
            diff = self.resolution - r
            datum = np.pad(datum, ((0, 0), (0, diff), (0, diff), (0, diff)))
        # channels-first file layout -> channels-last device layout
        return np.ascontiguousarray(np.moveaxis(datum, 0, -1))


class GridLoader:
    """Shuffling, prefetching batch iterator.

    Yields (B, R, R, R, 4) float32 numpy batches forever (epoch-wrapping,
    like the reference's StopIteration-and-restart loop, trainer.py:97-105).
    """

    def __init__(self, dataset: ShapeNetDMTetDataset, batch_size: int,
                 num_workers: int = 4, seed: int = 0, prefetch: int = 2,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.pool = concurrent.futures.ThreadPoolExecutor(max(num_workers, 1))
        self.prefetch = prefetch
        self._q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _index_stream(self) -> Iterator[np.ndarray]:
        n = len(self.dataset)
        while True:
            perm = self.rng.permutation(n)
            for s in range(0, n - self.batch_size + 1, self.batch_size):
                yield perm[s:s + self.batch_size]

    def _producer(self):
        for idxs in self._index_stream():
            if self._stop.is_set():
                return
            # the jitters drawn in batch order, whichever worker takes a sample,
            # so two loaders with one seed give the same batches (spatial peers)
            jitters = [self.dataset.draw_jitter() for _ in idxs]
            samples = list(self.pool.map(self.dataset.__getitem__, idxs, jitters))
            batch = np.stack(samples)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return self._q.get()

    def close(self):
        """Stop the producer (after the batch it is loading) and the pool."""
        self._stop.set()
        self._thread.join(timeout=30.0)
        self.pool.shutdown(wait=False)
