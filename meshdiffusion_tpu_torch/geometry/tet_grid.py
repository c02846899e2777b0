"""Static tetrahedral-grid structures, precomputed once per resolution.

Counterpart of ``meshdiffusion_tpu/geometry/tet_grid.py``. The tet grid
never changes, so its unique-edge table, the (T, 6) map from each tet's
six local edges into it and the vertex -> cubic-grid coordinate map are
precomputed once on the host with numpy; marching tets is then pure
fixed-shape gather arithmetic on the device (``marching_tets.py``).

The 64 grid is the port's own copy of the reference's asset
(``assets/64_tets_cropped.npz``). A resolution with no asset (the 128 grid:
the reference ships none) is generated as a Kuhn lattice
(``generate_tets.py``) and its derived arrays cached on disk, as the JAX
package does, under the port's own cache directory.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# Marching-tetrahedra tables (Kaolin convention; reference
# nvdiffrec/lib/geometry/dmtet.py:34-54). Row = occupancy case 0..15,
# entries = local edge slots (0..5) in BASE_TET_EDGES order, -1 = unused.
TRIANGLE_TABLE = np.array([
    [-1, -1, -1, -1, -1, -1],
    [1, 0, 2, -1, -1, -1],
    [4, 0, 3, -1, -1, -1],
    [1, 4, 2, 1, 3, 4],
    [3, 1, 5, -1, -1, -1],
    [2, 3, 0, 2, 5, 3],
    [1, 4, 0, 1, 5, 4],
    [4, 2, 5, -1, -1, -1],
    [4, 5, 2, -1, -1, -1],
    [4, 1, 0, 4, 5, 1],
    [3, 2, 0, 3, 5, 2],
    [1, 3, 5, -1, -1, -1],
    [4, 1, 2, 4, 3, 1],
    [3, 0, 4, -1, -1, -1],
    [2, 0, 1, -1, -1, -1],
    [-1, -1, -1, -1, -1, -1],
], dtype=np.int32)

NUM_TRIANGLES_TABLE = np.array(
    [0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0], dtype=np.int32)

BASE_TET_EDGES = np.array([0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3], dtype=np.int32)

DEFAULT_TET_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', 'assets'))

_DERIVED = ('verts', 'indices', 'unique_edges', 'tet_edge_to_unique', 'vert_grid_coords')


def cache_path(resolution: int) -> str:
    """Where a generated grid's derived arrays are cached:
    ``$XDG_CACHE_HOME`` (default ``~/.cache``) ``/meshdiffusion_tpu_torch/
    tetgrid_gen_{R}.npz``."""
    root = os.environ.get('XDG_CACHE_HOME') or os.path.join(os.path.expanduser('~'), '.cache')
    return os.path.join(root, 'meshdiffusion_tpu_torch', f'tetgrid_gen_{resolution}.npz')


@dataclasses.dataclass(frozen=True)
class TetGrid:
    """Immutable static structure of one tetrahedral grid resolution."""

    resolution: int                    # cubic grid resolution R
    verts: np.ndarray                  # (V, 3) f32, raw (unscaled) positions
    indices: np.ndarray                # (T, 4) i32 tet vertex ids
    unique_edges: np.ndarray           # (E, 2) i32, sorted pairs, lexsorted
    tet_edge_to_unique: np.ndarray     # (T, 6) i32 -> unique edge id
    vert_grid_coords: np.ndarray       # (V, 3) i32 integer cubic-grid coords
    _device_cache: Dict = dataclasses.field(default_factory=dict, compare=False,
                                            repr=False)

    @staticmethod
    @functools.lru_cache(maxsize=4)
    def load(resolution: int = 64, tet_dir: Optional[str] = None) -> "TetGrid":
        """Load ``{tet_dir}/{R}_tets_cropped.npz`` (default: the bundled
        assets, which hold the 64 grid). Where there is no such file,
        generate the Kuhn-lattice grid with the same vertex lattice and cache
        its derived arrays at :func:`cache_path` (at R=128 generating takes
        tens of seconds, reading the cache a few); a failed cache write is
        ignored, as in the JAX package, a failed generation raises."""
        path = os.path.join(tet_dir or DEFAULT_TET_DIR, f'{resolution}_tets_cropped.npz')
        if os.path.exists(path):
            data = np.load(path)
            return TetGrid.from_arrays(resolution, np.asarray(data['vertices'], np.float32),
                                       np.asarray(data['indices'], np.int32))
        cache = cache_path(resolution)
        if os.path.exists(cache):
            with np.load(cache) as d:
                return TetGrid(resolution=resolution, **{k: d[k] for k in _DERIVED})
        from .generate_tets import generate_tet_grid
        tg = TetGrid.from_arrays(resolution, *generate_tet_grid(resolution))
        try:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            tmp = cache + '.tmp.npz'      # written whole, then renamed
            np.savez(tmp, **{k: getattr(tg, k) for k in _DERIVED})
            os.replace(tmp, cache)
        except OSError:
            pass
        return tg

    @staticmethod
    def from_arrays(resolution: int, verts: np.ndarray, indices: np.ndarray) -> "TetGrid":
        # Normalize tet parity: the TRIANGLE_TABLE winding assumes positively
        # oriented tets. Swapping two vertices flips parity; the occupancy
        # case permutes consistently, so geometry is unchanged.
        d = np.einsum('ij,ij->i',
                      np.cross(verts[indices[:, 1]] - verts[indices[:, 0]],
                               verts[indices[:, 2]] - verts[indices[:, 0]]),
                      verts[indices[:, 3]] - verts[indices[:, 0]])
        neg = d < 0
        if neg.any():
            indices = indices.copy()
            indices[neg, 2], indices[neg, 3] = (indices[neg, 3], indices[neg, 2].copy())
        # unique edges on one int64 key a*V + b (a < b): the lexicographic
        # order and inverse of np.unique(axis=0) over the (a, b) rows, in a
        # tenth of its time (seconds, not minutes, for the 128 grid's 72M)
        edges = np.sort(indices[:, BASE_TET_EDGES].reshape(-1, 2), axis=1).astype(np.int64)
        V = np.int64(verts.shape[0])
        keys, inverse = np.unique(edges[:, 0] * V + edges[:, 1], return_inverse=True)
        unique_edges = np.stack([keys // V, keys % V], axis=1)
        u = np.unique(verts)
        dx = float(u[1] - u[0])
        return TetGrid(resolution=resolution, verts=verts, indices=indices,
                       unique_edges=unique_edges.astype(np.int32),
                       tet_edge_to_unique=inverse.reshape(-1, 6).astype(np.int32),
                       vert_grid_coords=np.round((verts - verts.min()) / dx).astype(np.int32))

    @property
    def num_verts(self) -> int:
        return self.verts.shape[0]

    @property
    def num_tets(self) -> int:
        return self.indices.shape[0]

    @property
    def num_edges(self) -> int:
        return self.unique_edges.shape[0]

    def tensor(self, name: str, device) -> torch.Tensor:
        """One of the grid's arrays as a tensor on ``device`` (int64 for the
        index tables), uploaded once per device."""
        key = (name, str(device))
        if key not in self._device_cache:
            arr = getattr(self, name)
            dtype = torch.float32 if arr.dtype.kind == 'f' else torch.int64
            self._device_cache[key] = torch.as_tensor(arr, dtype=dtype, device=device)
        return self._device_cache[key]

    def grid_mask(self) -> np.ndarray:
        """(R, R, R) f32 occupancy mask (reference data/get_tet_mask.py:9-15)."""
        R = self.resolution
        mask = np.zeros((R, R, R), np.float32)
        c = self.vert_grid_coords
        mask[c[:, 0], c[:, 1], c[:, 2]] = 1.0
        return mask

    def grid_to_tet(self, grid: torch.Tensor, normalize_sdf: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-vertex (sdf, deform) from a (R, R, R, 4) channels-last grid:
        sdf is the sign of channel 0 with 0 mapped to +1 (when
        normalize_sdf), deform = channels 1:4 clipped to [-1, 1]
        (reference nvdiffrec/eval.py:405-419)."""
        c = self.tensor('vert_grid_coords', grid.device)
        vals = grid[c[:, 0], c[:, 1], c[:, 2], :]
        sdf = vals[:, 0]
        if normalize_sdf:
            s = torch.sign(sdf)
            sdf = torch.where(s == 0, torch.ones_like(s), s)
        return sdf, vals[:, 1:4].clamp(-1.0, 1.0)

    def tet_to_grid(self, sdf: torch.Tensor, deform: torch.Tensor) -> torch.Tensor:
        """Per-vertex (sdf (V,), deform (V, 3)) scattered into a (R, R, R, 4)
        channels-last grid, zero elsewhere, on their device (reference
        data/tets_to_3dgrid.py:7-15)."""
        R = self.resolution
        c = self.tensor('vert_grid_coords', sdf.device)
        grid = torch.zeros((R, R, R, 4), dtype=sdf.dtype, device=sdf.device)
        grid[c[:, 0], c[:, 1], c[:, 2]] = torch.cat([sdf[:, None], deform.to(sdf.dtype)], dim=1)
        return grid

    def deformed_verts(self, deform: torch.Tensor, scale: float = 1.0,
                       deform_scale: float = 1.0) -> torch.Tensor:
        """verts*scale + 2/(2*R) * deform * deform_scale (reference dmtet.py:293-304)."""
        base = self.tensor('verts', deform.device) * scale
        return base + 2.0 / (self.resolution * 2) * deform * deform_scale
