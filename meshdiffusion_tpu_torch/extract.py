"""Batch mesh extraction: generated .npy grids -> post-processed .obj meshes.

Counterpart of ``meshdiffusion_tpu/extract.py`` (reference
``nvdiffrec/eval.py:300-456``): per sample, gather the SDF sign and the
deformation at the tet vertices, run marching tets on the device, compact
on the host, then isotropic remesh -> Laplacian smooth -> remesh, and
write the .obj.
"""

from __future__ import annotations

import glob
import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .geometry.marching_tets import MarchingTetsOutput, compact_mesh, marching_tets
from .geometry.obj_io import write_obj
from .geometry.remesh import isotropic_remesh
from .geometry.smoothing import laplacian_smooth
from .geometry.tet_grid import TetGrid
from .utils.device import resolve_device

logger = logging.getLogger(__name__)


def make_grid_to_mesh(tet_grid: TetGrid, mesh_scale: float = 2.1, deform_scale: float = 1.0,
                      unnormalized_sdf: bool = False
                      ) -> Callable[[torch.Tensor], MarchingTetsOutput]:
    """(R, R, R, 4) channels-last grid tensor -> padded marching-tets mesh,
    on the grid's device."""
    def fn(grid: torch.Tensor) -> MarchingTetsOutput:
        sdf, deform = tet_grid.grid_to_tet(grid, normalize_sdf=not unnormalized_sdf)
        vpos = tet_grid.deformed_verts(deform, scale=mesh_scale, deform_scale=deform_scale)
        return marching_tets(tet_grid, vpos, sdf)
    return fn


def extract_grid(grid: np.ndarray, tet_grid: TetGrid, out_path: str,
                 mesh_scale: float = 2.1, deform_scale: float = 1.0,
                 num_smooth_steps: int = 3, unnormalized_sdf: bool = False,
                 remesh: bool = True, device='cuda'):
    """One (4, R, R, R) channel-first grid -> post-processed .obj; returns
    (verts, faces), computed on ``device`` (the card unless the caller names
    another; raises where CUDA is missing). Post-process order mirrors reference eval.py:449-456:
    isotropic remeshing -> uniform Laplacian smoothing (num_smooth_steps)
    -> isotropic remeshing; ``remesh=False`` smooths the raw tessellation."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    g = torch.as_tensor(np.moveaxis(np.asarray(grid, np.float32), 0, -1), device=device)
    fn = make_grid_to_mesh(tet_grid, mesh_scale, deform_scale, unnormalized_sdf)
    verts, faces = compact_mesh(fn(g))
    t1 = time.perf_counter()
    if remesh and len(faces):
        verts, faces = isotropic_remesh(verts, faces)
    if num_smooth_steps > 0 and len(faces):
        verts = laplacian_smooth(torch.as_tensor(verts, device=device),
                                 torch.as_tensor(faces.astype(np.int64), device=device),
                                 steps=num_smooth_steps).cpu().numpy()
    if remesh and len(faces):
        verts, faces = isotropic_remesh(verts, faces)
    t2 = time.perf_counter()
    write_obj(out_path, verts, faces)
    logger.info('%s: %d verts, %d faces (marching tets %.3f s, post-process %.3f s)',
                out_path, len(verts), len(faces), t1 - t0, t2 - t1,
                extra={'marching_s': t1 - t0, 'postprocess_s': t2 - t1})
    return verts, faces


def extract_batch(sample_path: str, out_dir: str, resolution: int = 64,
                  mesh_scale: float = 2.1, deform_scale: float = 1.0,
                  num_smooth_steps: int = 3, unnormalized_sdf: bool = False,
                  tet_root: Optional[str] = None, remesh: bool = True, device='cuda'):
    """Every sample of one channel-first .npy batch -> ``out_dir/mesh/%06d.obj``
    (reference eval.py:400-456), on ``device`` as :func:`extract_grid`."""
    device = resolve_device(device)
    tg = TetGrid.load(resolution, tet_root or None)
    mesh_dir = os.path.join(out_dir, 'mesh')
    os.makedirs(mesh_dir, exist_ok=True)
    data_all = np.load(sample_path)
    logger.info('shape of generated data %s', data_all.shape)
    paths = []
    for i in range(data_all.shape[0]):
        p = os.path.join(mesh_dir, f'{i:06d}.obj')
        extract_grid(data_all[i], tg, p, mesh_scale, deform_scale, num_smooth_steps,
                     unnormalized_sdf, remesh=remesh, device=device)
        paths.append(p)
    return paths


def extract_dir(sample_dir: str, out_dir: str, **kw):
    """Every ``.npy`` batch under ``sample_dir``, in name order, to
    ``out_dir/time{k:03d}/mesh/`` (trajectory evaluation, reference
    eval_traj.py:398-452); ``kw`` as :func:`extract_batch` takes them."""
    paths = []
    for k, f in enumerate(sorted(glob.glob(os.path.join(sample_dir, '*.npy')))):
        paths += extract_batch(f, os.path.join(out_dir, f'time{k:03d}'), **kw)
    return paths
