"""Wavefront OBJ mesh I/O with materials.

Counterpart of ``meshdiffusion_tpu/render/obj.py`` (reference
``nvdiffrec/lib/render/obj.py``: load_obj:31-160, write_obj:165-216):
parses v / vt / vn / f with mtllib / usemtl, fan-triangulates, merges a
multi-material mesh into one atlas material, and gives a mesh without
materials the default 'pbr' material.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import material as material_mod
from .mesh import Mesh
from .texture import Texture2D


def _split_idx(s: str):
    comp = (s.split('/') + ['', ''])[:3]
    return (int(comp[0]) - 1, int(comp[1]) - 1 if comp[1] else -1,
            int(comp[2]) - 1 if comp[2] else -1)


def load_obj(filename: str, clear_ks: bool = True, mtl_override: Optional[str] = None,
             device=None) -> Mesh:
    """Read an .obj (and the .mtl it names, or ``mtl_override``) onto
    ``device``. Texture v is flipped (1 - v), as the reference does."""
    obj_path = os.path.dirname(filename)
    verts, texcoords, normals = [], [], []
    faces, tfaces, nfaces, mfaces = [], [], [], []
    all_materials, used_materials = [], []
    active_mat = -1

    with open(filename) as f:
        lines = f.readlines()

    # pass 1: materials
    for line in lines:
        parts = line.split()
        if parts and parts[0] == 'mtllib':
            path = mtl_override if mtl_override else os.path.join(obj_path, parts[1])
            if os.path.exists(path):
                all_materials += material_mod.load_mtl(path, clear_ks)
    mat_by_name = {m.get('name'): m for m in all_materials}

    # pass 2: geometry
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        tag = parts[0]
        if tag == 'v':
            verts.append([float(v) for v in parts[1:4]])
        elif tag == 'vt':
            val = [float(v) for v in parts[1:3]]
            texcoords.append([val[0], 1.0 - val[1]])
        elif tag == 'vn':
            normals.append([float(v) for v in parts[1:4]])
        elif tag == 'usemtl':
            m = mat_by_name.get(parts[1])
            if m is None:
                active_mat = -1
            else:
                if not any(m is u for u in used_materials):
                    used_materials.append(m)
                active_mat = next(i for i, u in enumerate(used_materials) if u is m)
        elif tag == 'f':
            v0, t0, n0 = _split_idx(parts[1])
            for i in range(len(parts) - 3):          # fan triangulation
                v1, t1, n1 = _split_idx(parts[i + 2])
                v2, t2, n2 = _split_idx(parts[i + 3])
                faces.append([v0, v1, v2])
                tfaces.append([t0, t1, t2])
                nfaces.append([n0, n1, n2])
                mfaces.append(max(active_mat, 0))

    if not faces:
        raise ValueError(f'{filename}: empty mesh')
    if not used_materials:
        used_materials = [material_mod.Material({
            'name': '_default',
            'bsdf': 'pbr',
            'kd': Texture2D(np.asarray([0.5, 0.5, 0.5], np.float32)),
            'ks': Texture2D(np.asarray([0.0, 0.5, 0.0], np.float32)),
        })]
    if not texcoords:
        texcoords = [[0.0, 0.0]]
        tfaces = [[0, 0, 0]] * len(faces)
    uber, texcoords, tfaces = material_mod.merge_materials(used_materials, texcoords, tfaces,
                                                           mfaces)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def flt(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Mesh(v_pos=flt(verts), t_pos_idx=idx(faces), v_tex=flt(texcoords),
                t_tex_idx=idx(tfaces), v_nrm=flt(normals) if normals else None,
                t_nrm_idx=idx(nfaces) if normals else None, material=uber.to(device))


def load_mesh(filename: str, mtl_override: Optional[str] = None, device=None) -> Mesh:
    """Dispatch by extension (reference mesh.py:99-103)."""
    if not filename.lower().endswith('.obj'):
        raise ValueError(f'unsupported format: {filename}')
    return load_obj(filename, clear_ks=True, mtl_override=mtl_override, device=device)


def write_obj(folder: str, mesh: Mesh, save_material: bool = True) -> str:
    """Write ``folder/mesh.obj`` (v, vt with v flipped back, vn, f v/t/n)
    and, with ``save_material``, ``mesh.mtl`` and its textures
    (reference obj.py:165-216). Returns the .obj's path."""
    os.makedirs(folder, exist_ok=True)
    obj_file = os.path.join(folder, 'mesh.obj')

    def host(t):
        return None if t is None else t.detach().cpu().numpy()
    v_pos, t_pos_idx = host(mesh.v_pos), host(mesh.t_pos_idx)
    v_tex, t_tex_idx = host(mesh.v_tex), host(mesh.t_tex_idx)
    v_nrm, t_nrm_idx = host(mesh.v_nrm), host(mesh.t_nrm_idx)

    with open(obj_file, 'w') as f:
        f.write('mtllib mesh.mtl\ng default\n')
        # numpy scalars formatted as the JAX package formats them, so both
        # write the same bytes
        for v in v_pos:
            f.write(f'v {v[0]} {v[1]} {v[2]}\n')
        if v_tex is not None:
            for t in v_tex:
                f.write(f'vt {t[0]} {1.0 - t[1]}\n')
        if v_nrm is not None:
            for n in v_nrm:
                f.write(f'vn {n[0]} {n[1]} {n[2]}\n')
        f.write('s 1\ng pMesh1\nusemtl defaultMat\n')
        for i in range(len(t_pos_idx)):
            f.write('f ')
            for j in range(3):
                ti = '' if t_tex_idx is None else t_tex_idx[i][j] + 1
                ni = '' if t_nrm_idx is None else t_nrm_idx[i][j] + 1
                f.write(f' {t_pos_idx[i][j] + 1}/{ti}/{ni}')
            f.write('\n')

    if save_material and mesh.material is not None:
        material_mod.save_mtl(os.path.join(folder, 'mesh.mtl'), mesh.material)
    return obj_file
