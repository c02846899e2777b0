"""The (R, R, R) grid mask: 1 at each cubic-grid point that holds a vertex
of the tet grid (MeshDiffusion's data/get_tet_mask.py), worked out from the
grid's vertex positions.

The 64 grid's vertices are read from the tet-grid file itself; a grid with
no file (128) is the regular lattice of R-1 coordinates per axis, 1/R
apart and centred, that the port generates for it."""

from __future__ import annotations

import numpy as np


def lattice_verts(R: int) -> np.ndarray:
    c = (np.arange(R - 1) - (R - 2) / 2.0) / R
    return np.stack(np.meshgrid(c, c, c, indexing='ij'), -1).reshape(-1, 3)


def grid_mask(R: int, verts: np.ndarray) -> np.ndarray:
    v = np.asarray(verts, np.float64)
    dx = 1.0 / R
    idx = np.rint((v - v.min(axis=0)) / dx).astype(np.int64)
    mask = np.zeros((R, R, R), np.float32)
    mask[idx[:, 0], idx[:, 1], idx[:, 2]] = 1.0
    return mask


def load(R: int, tet_file: str = '') -> np.ndarray:
    """The mask from ``tet_file`` (an .npz with ``vertices``), or from the
    generated lattice where none is given."""
    if tet_file:
        with np.load(tet_file) as d:
            return grid_mask(R, d['vertices'])
    return grid_mask(R, lattice_verts(R))
