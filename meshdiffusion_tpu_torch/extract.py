"""Batch mesh extraction: generated .npy grids -> post-processed .obj meshes.

Counterpart of ``meshdiffusion_tpu/extract.py`` (reference
``nvdiffrec/eval.py:300-456``): per sample, gather the SDF sign and the
deformation at the tet vertices, run marching tets on the device, compact
on the host, then isotropic remesh -> Laplacian smooth -> remesh, and
write the .obj; with ``save_viz`` also a sanity PNG of each mesh
(:func:`render_viz`, one render on the device).

Marching tets keeps one layout at every resolution: the (T, 6) and (2T, 3)
tables in device memory. On the 128 grid (12,002,256 tets) that is about
1.3 GB of int64 tables; the JAX package's structure-of-arrays variant
exists for the TPU's 128-lane padding of such tables, which the card does
not have.
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
    logger.info('%s: %d verts, %d faces (marching tets %.3f s, post-process %.3f s, '
                '.obj %.3f s)', out_path, len(verts), len(faces), t1 - t0, t2 - t1,
                time.perf_counter() - t2,
                extra={'marching_s': t1 - t0, 'postprocess_s': t2 - t1,
                       'mesh_size': (len(verts), len(faces))})
    return verts, faces


def viz_camera(angle_ind: int = 25, display_res=(512, 512), cam_radius: float = 3.0):
    """(mvp (1, 4, 4), campos (1, 3)) float32 of the sanity render's pose:
    pose ``angle_ind`` of 50 around the mesh, 0.4 rad above it."""
    from .render import utils as rutils
    proj = rutils.perspective(np.deg2rad(45), display_res[1] / display_res[0], 0.1, 1000.0)
    ang = (angle_ind / 50) * np.pi * 2
    mv = rutils.translate(0, 0, -cam_radius) @ (rutils.rotate_x(-0.4) @ rutils.rotate_y(ang))
    return (proj @ mv)[None], np.linalg.inv(mv)[:3, 3][None].astype(np.float32)


# the rasterizer's capacities a sanity render starts from (the JAX package's
# render_mesh defaults) and the most each may grow to (a res128 mesh puts
# ~8,000 triangles into its densest 32x32 tile at 512^2)
_VIZ_CAPS = {'raster_K': (256, 1 << 15), 'raster_Kg': (64, 1024), 'raster_live': (65536, 2 ** 23)}


def render_viz(verts: np.ndarray, faces: np.ndarray, out_png: str, angle_ind: int = 25,
               display_res=(512, 512), cam_radius: float = 3.0, device='cuda') -> dict:
    """Sanity PNG of a mesh at a circular pose (reference eval.py:182-201,
    434-438: rotate_scene + validate_itr with the default diffuse material
    under a white environment): one depth layer through the port's
    renderer on ``device``, so the z-test kernel runs once a render on the
    card. A render whose binning overflows the rasterizer's capacities is
    redone with them grown (the JAX package keeps its first render, whose
    image then lacks the triangles it dropped: a res128 mesh has ~200k
    faces, past the 65,536 live-face default). Returns the last render's
    buffers."""
    from .fitting.fit import RASTER_CAPS, default_material
    from .render import mesh as mesh_mod
    from .render import utils as rutils
    from .render.light import EnvironmentLight
    from .render.rasterize import grow_capacity
    from .render.render import render_mesh
    device = resolve_device(device)
    m = mesh_mod.Mesh(v_pos=torch.as_tensor(verts, dtype=torch.float32, device=device),
                      t_pos_idx=torch.as_tensor(faces.astype(np.int64), device=device),
                      material=default_material(device))
    m = mesh_mod.auto_normals(m)
    mvp, campos = viz_camera(angle_ind, display_res, cam_radius)
    light = EnvironmentLight(torch.ones((6, 16, 16, 3), device=device))
    light.build_mips()
    caps = {k: first for k, (first, _) in _VIZ_CAPS.items()}
    for renders in range(1, 8):
        with torch.no_grad():
            out = render_mesh(m, torch.as_tensor(mvp), torch.as_tensor(campos), light,
                              display_res, num_layers=1, **caps)
        over = {key: int(out[key]) for _, key in RASTER_CAPS}
        grown = {k: grow_capacity(caps[k], over[key], _VIZ_CAPS[k][1]) for k, key in RASTER_CAPS}
        if grown == caps:
            break
        caps = grown
    logger.info('%s: %d render(s), capacities %s, overflow %s', out_png, renders, caps, over,
                extra={'viz_renders': renders, 'viz_overflow': over})
    img = rutils.rgb_to_srgb(out['shaded'][0, ..., :3])
    rutils.save_image(out_png, img.cpu().numpy())
    return out


def extract_batch(sample_path: str, out_dir: str, resolution: int = 64,
                  mesh_scale: float = 2.1, deform_scale: float = 1.0,
                  num_smooth_steps: int = 3, unnormalized_sdf: bool = False,
                  tet_root: Optional[str] = None, save_viz: bool = False,
                  angle_ind: int = 25, remesh: bool = True, device='cuda'):
    """Every sample of one channel-first .npy batch -> ``out_dir/mesh/%06d.obj``
    (reference eval.py:400-456), on ``device`` as :func:`extract_grid`; with
    ``save_viz`` also ``out_dir/viz/viz_%06d.png`` of each non-empty mesh."""
    device = resolve_device(device)
    tg = TetGrid.load(resolution, tet_root or None)
    mesh_dir = os.path.join(out_dir, 'mesh')
    os.makedirs(mesh_dir, exist_ok=True)
    if save_viz:
        os.makedirs(os.path.join(out_dir, 'viz'), exist_ok=True)
    data_all = np.load(sample_path)
    logger.info('shape of generated data %s', data_all.shape)
    paths = []
    for i in range(data_all.shape[0]):
        p = os.path.join(mesh_dir, f'{i:06d}.obj')
        v, f = extract_grid(data_all[i], tg, p, mesh_scale, deform_scale, num_smooth_steps,
                            unnormalized_sdf, remesh=remesh, device=device)
        if save_viz and len(f):
            render_viz(v, f, os.path.join(out_dir, 'viz', f'viz_{i:06d}.png'),
                       angle_ind=angle_ind, device=device)
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
