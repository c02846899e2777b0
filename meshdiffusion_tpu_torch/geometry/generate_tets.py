"""Uniform tetrahedral grid generation for arbitrary resolutions.

A copy of ``meshdiffusion_tpu/geometry/generate_tets.py`` (numpy only),
kept here so that the port imports nothing of the JAX package. It stands
in for the reference's ``nvdiffrec/data/tets/generate_tets.py`` (which
runs the external ``quartet`` binary) and ``crop_tets.py``; the reference
ships only the 64 grid, so the 128 grid is generated here:

* vertices on a regular lattice of (R-1) coordinates per axis with spacing
  1/R, centred: coords_i = (i - (R-2)/2) / R (for R=64 exactly the bundled
  asset's vertex lattice, 63 coordinates spanning +-0.484375);
* every lattice cell split into 6 Kuhn tetrahedra (a translationally
  symmetric tetrahedralization, which is what crop_tets.py aims for).

The connectivity differs from quartet's BCC meshing, so a generated grid
serves new datasets and training but is not interchangeable with dicts
fitted on the reference's own 128 grid. The vertex lattice, and so the
grid mask and the grid <-> tet resampling, is the same.
"""

from __future__ import annotations

import argparse

import numpy as np

# Kuhn (Freudenthal) subdivision of the unit cube into 6 tets around the
# main diagonal (0 -> 7); corner ids are (x + 2y + 4z) bit codes.
KUHN_TETS = np.asarray([
    (0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
    (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7),
], np.int64)


def generate_tet_grid(resolution: int):
    """Build (vertices (V, 3) f32, indices (T, 4) i32) for one resolution.

    V = (R-1)^3, T = 6 (R-2)^3.
    """
    n = resolution - 1  # unique lattice coords per axis
    coords = (np.arange(n) - (n - 1) / 2.0) / resolution
    gx, gy, gz = np.meshgrid(coords, coords, coords, indexing='ij')
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)

    i, j, k = np.meshgrid(np.arange(n - 1), np.arange(n - 1),
                          np.arange(n - 1), indexing='ij')
    base = (i * n + j) * n + k                       # (n-1)^3 cell origins
    base = base.reshape(-1)
    # corner offsets for bit code b = x + 2y + 4z: x->k(+1), y->j(+n), z->i(+n^2)
    offs = np.asarray([(b & 1) + ((b >> 1) & 1) * n + ((b >> 2) & 1) * n * n
                       for b in range(8)], np.int64)
    corners = base[:, None] + offs[None, :]          # (C, 8)
    tets = corners[:, KUHN_TETS].reshape(-1, 4)      # (C*6, 4)
    return verts, tets.astype(np.int32)


def crop_tets(vertices: np.ndarray, indices: np.ndarray):
    """Drop the outermost vertex layer and every tet touching it
    (vectorized counterpart of reference crop_tets.py:16-63; the quartet
    output has an irregular boundary layer that breaks translational
    symmetry)."""
    assert indices.shape[1] == 4
    mask = np.ones(len(vertices), bool)
    for k in range(3):
        mask &= ((vertices[:, k] != vertices[:, k].min())
                 & (vertices[:, k] != vertices[:, k].max()))
    remap = -np.ones(len(vertices), np.int64)
    remap[mask] = np.arange(int(mask.sum()))
    keep = mask[indices].all(axis=1)
    return (vertices[mask],
            remap[indices[keep]].astype(np.int32))


def save_tet_grid(resolution: int, out_path: str = None) -> str:
    verts, tets = generate_tet_grid(resolution)
    out_path = out_path or f'{resolution}_tets_cropped.npz'
    np.savez(out_path, vertices=verts, indices=tets)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser('meshdiffusion_tpu_torch.geometry.generate_tets')
    p.add_argument('--resolution', type=int, required=True)
    p.add_argument('--out', default=None)
    p.add_argument('--crop', default=None,
                   help='crop an existing {R}_tets.npz (reference '
                   'crop_tets.py CLI) instead of generating')
    args = p.parse_args(argv)
    if args.crop:
        data = np.load(args.crop)
        v, t = crop_tets(np.asarray(data['vertices']),
                         np.asarray(data['indices']))
        out = args.out or args.crop.replace('.npz', '_cropped.npz')
        np.savez_compressed(out, vertices=v, indices=t)
        print(f'{out}: {len(v)} verts, {len(t)} tets (cropped)')
        return
    path = save_tet_grid(args.resolution, args.out)
    v, t = generate_tet_grid(args.resolution)
    print(f'{path}: {len(v)} verts, {len(t)} tets')


if __name__ == '__main__':
    main()
