"""Baked-texture mesh export (reference ``nvdiffrec/eval.py:96-128``).

Counterpart of ``meshdiffusion_tpu/fitting/export.py``:
``uv_unwrap.parametrize`` (the xatlas equivalent, host numpy) lays the
mesh out in a UV atlas; ``render.render_uv`` rasterizes the charts in UV
space on the mesh's device, sampling the neural material at the
interpolated 3D positions; texels outside every chart are filled by seam
dilation (as xatlas bakers do, so bilinear filtering survives); the kd, ks
and normal maps become a Texture2D material written beside the .obj.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..geometry.uv_unwrap import parametrize
from ..render import material as material_mod
from ..render import mesh as mesh_mod
from ..render import obj as obj_mod
from ..render.render import render_uv
from ..render.texture import Texture2D

logger = logging.getLogger(__name__)

# MLP material channel ranges (reference eval.py:134-142)
_KD_MIN, _KD_MAX = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
_KS_MIN, _KS_MAX = (0.0, 0.08, 0.0), (1.0, 1.0, 1.0)
_NRM_MIN, _NRM_MAX = (-1.0, -1.0, 0.0), (1.0, 1.0, 1.0)


def dilate_texels(img: np.ndarray, mask: np.ndarray, steps: int = 8) -> np.ndarray:
    """Flood chart colours outward into empty texels (seam padding): each
    step fills an empty texel with the mean of its filled 4-neighbours."""
    img = img.copy()
    filled = mask.astype(bool).copy()
    for _ in range(steps):
        if filled.all():
            break
        acc = np.zeros_like(img)
        cnt = np.zeros(img.shape[:2], img.dtype)
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            src_f = np.roll(filled, (dy, dx), (0, 1))
            src_i = np.roll(img, (dy, dx), (0, 1))
            # roll wraps; mask the wrapped border
            if dy == 1:
                src_f[0] = False
            elif dy == -1:
                src_f[-1] = False
            if dx == 1:
                src_f[:, 0] = False
            elif dx == -1:
                src_f[:, -1] = False
            acc += src_i * src_f[..., None]
            cnt += src_f
        new = ~filled & (cnt > 0)
        img[new] = acc[new] / cnt[new][..., None]
        filled |= new
    return img


def uvmap_mesh(eval_mesh: mesh_mod.Mesh, mlp_texture, texture_res=(1024, 1024)
               ) -> mesh_mod.Mesh:
    """xatlas_uvmap equivalent (reference eval.py:96-128): a new mesh with
    ``v_tex`` / ``t_tex_idx`` and the material baked into Texture2D maps."""
    dev = eval_mesh.v_pos.device
    v = eval_mesh.v_pos.detach().cpu().numpy()
    f = eval_mesh.t_pos_idx.cpu().numpy()
    t0 = time.perf_counter()
    vmapping, t_tex_idx, uvs = parametrize(v, f)
    parametrize_s = time.perf_counter() - t0
    logger.info('uv atlas: verts %d -> %d, %d faces, in %.3f s', len(v), len(vmapping), len(f),
                parametrize_s, extra={'parametrize': (len(f), len(vmapping), parametrize_s)})

    new_mesh = mesh_mod.Mesh.combine(
        eval_mesh, v_tex=torch.as_tensor(uvs, device=dev),
        t_tex_idx=torch.as_tensor(t_tex_idx.astype(np.int64), device=dev))
    mask, kd, ks, normal = render_uv(new_mesh, texture_res, mlp_texture)
    m2 = mask[..., 0].cpu().numpy()
    kd, ks, normal = (dilate_texels(t.detach().cpu().numpy(), m2) for t in (kd, ks, normal))
    bsdf = eval_mesh.material['bsdf'] if eval_mesh.material is not None else 'pbr'
    new_mesh.material = material_mod.Material({
        'name': 'baked',
        'bsdf': bsdf,
        'kd': Texture2D(kd, min_max=(np.asarray(_KD_MIN), np.asarray(_KD_MAX))),
        'ks': Texture2D(ks, min_max=(np.asarray(_KS_MIN), np.asarray(_KS_MAX))),
        'normal': Texture2D(normal, min_max=(np.asarray(_NRM_MIN), np.asarray(_NRM_MAX))),
    })
    return new_mesh


def export_baked(eval_mesh: mesh_mod.Mesh, mlp_texture, out_folder: str,
                 texture_res=(1024, 1024)) -> str:
    """Bake and write mesh.obj / mesh.mtl / textures (reference
    eval.py:385-398); returns the .obj's path."""
    baked = uvmap_mesh(eval_mesh, mlp_texture, texture_res)
    return obj_mod.write_obj(out_folder, baked, save_material=True)
