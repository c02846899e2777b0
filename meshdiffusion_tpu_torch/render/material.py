"""Materials: a dict of textures and strings, with .mtl load and save.

Counterpart of ``meshdiffusion_tpu/render/material.py`` (reference
``nvdiffrec/lib/render/material.py``: the container:21-44,
load_mtl:50-99, save_mtl:104-131, merge:142-198). Keys: 'bsdf' (a
string), 'kd', 'ks', 'normal' (:class:`~.texture.Texture2D`), or
'kd_ks_normal' (a neural texture with a ``sample`` method).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from . import texture, utils
from .texture import Texture2D


class Material(dict):
    """dict with a device move for its textures."""

    def copy(self) -> "Material":
        return Material(dict(self))

    def to(self, device) -> "Material":
        return Material({k: v.to(device) if isinstance(v, Texture2D) else v
                         for k, v in self.items()})


def load_mtl(fn: str, clear_ks: bool = True) -> List[Material]:
    """Parse a .mtl file (reference material.py:50-99): kd / ks textures
    or constants, kd read as sRGB and made linear. A material without a
    ``bsdf`` line is 'pbr'; without kd, white; ks is zeroed unless given
    and ``clear_ks`` is False."""
    mtl_path = os.path.dirname(fn)
    materials = []
    mat: Optional[Material] = None
    with open(fn) as f:
        for line in f:
            split = line.split()
            if not split:
                continue
            prefix = split[0].lower()
            if prefix == 'newmtl':
                mat = Material({'name': split[1]})
                materials.append(mat)
            elif mat is None:
                continue
            elif prefix == 'bsdf':
                mat['bsdf'] = split[1]
            elif prefix == 'map_kd':
                mat['kd'] = texture.load_texture2D(os.path.join(mtl_path, split[1]),
                                                   lambda_fn=utils.srgb_to_rgb)
            elif prefix == 'map_ks':
                mat['ks'] = texture.load_texture2D(os.path.join(mtl_path, split[1]), channels=3)
            elif prefix == 'bump':
                mat['normal'] = texture.load_texture2D(os.path.join(mtl_path, split[1]),
                                                       lambda_fn=lambda x: x * 2 - 1, channels=3)
            elif prefix == 'kd':
                mat['kd'] = Texture2D(np.asarray([float(v) for v in split[1:4]], np.float32))
            elif prefix == 'ks':
                mat['ks'] = Texture2D(np.asarray([float(v) for v in split[1:4]], np.float32))
    for mat in materials:
        mat.setdefault('bsdf', 'pbr')
        if 'kd' not in mat:
            mat['kd'] = Texture2D(np.ones(3, np.float32))
        if 'ks' not in mat or clear_ks:
            mat['ks'] = Texture2D(np.zeros(3, np.float32))
    return materials


def save_mtl(fn: str, material: Material) -> None:
    """Write a .mtl and its texture PNGs beside it (reference
    material.py:104-131). The kd map is written as the one image
    ``texture_kd.png`` that the .mtl names, from the base level in sRGB
    (the JAX package converts the whole mip chain and so writes
    ``texture_kd_{level}.png``, none of which the .mtl names)."""
    folder = os.path.dirname(fn)
    with open(fn, 'w') as f:
        f.write('newmtl defaultMat\n')
        if material is not None:
            f.write(f"bsdf   {material.get('bsdf', 'pbr')}\n")
            if isinstance(material.get('kd'), Texture2D):
                f.write('map_Kd texture_kd.png\n')
                texture.save_texture2D(os.path.join(folder, 'texture_kd.png'),
                                       Texture2D(utils.rgb_to_srgb(material['kd'].get_mips()[0])))
            if isinstance(material.get('ks'), Texture2D):
                f.write('map_Ks texture_ks.png\n')
                texture.save_texture2D(os.path.join(folder, 'texture_ks.png'), material['ks'])
            if isinstance(material.get('normal'), Texture2D):
                f.write('bump texture_n.png\n')
                texture.save_texture2D(os.path.join(folder, 'texture_n.png'), material['normal'],
                                       lambda_fn=lambda x: (utils.safe_normalize(x) + 1) * 0.5)
        else:
            f.write('Kd 1 1 1\nKs 0 0 0\nKa 0 0 0\n')
        f.write('Tf 1 1 1\nNi 1\nNs 0\n')


def default_material(kd=(0.75, 0.3, 0.6), bsdf: str = 'diffuse') -> Material:
    """The constant diffuse material of the extraction renders
    (reference eval.py:422-428)."""
    return Material({
        'name': '_default_mat',
        'bsdf': bsdf,
        'kd': Texture2D(np.asarray(kd, np.float32)),
        'ks': Texture2D(np.asarray([0.0, 0.0, 0.0], np.float32)),
    })


def merge_materials(materials: List[Material], texcoords, tfaces, mfaces):
    """Merge per-face materials into one atlas material (reference
    material.py:142-198): kd and ks maps resized to the largest and laid
    side by side in u, each face's texture coordinates moved into its
    material's column. Returns (material, texcoords (N, 2), tfaces (F, 3))."""
    assert len(materials) > 0
    if len(materials) == 1:
        return materials[0], texcoords, tfaces
    res = [m['kd'].res if 'kd' in m else (1, 1) for m in materials]
    H = max(r[0] for r in res)
    W = max(r[1] for r in res)
    kds, kss = [], []
    for m in materials:
        kd = m['kd'].get_mips()[0]
        ks = m['ks'].get_mips()[0]
        kd = utils.scale_img_nhwc(kd, (H, W)) if tuple(kd.shape[1:3]) != (H, W) else kd
        ks = utils.scale_img_nhwc(ks, (H, W)) if tuple(ks.shape[1:3]) != (H, W) else ks
        kds.append(kd[0])
        kss.append(ks[0])
    kd_atlas = torch.cat(kds, dim=1)[None]
    ks_atlas = torch.cat(kss, dim=1)[None]

    tc = np.asarray(texcoords, np.float32).copy()
    tf = np.asarray(tfaces)
    mf = np.asarray(mfaces)
    n = len(materials)
    new_tc = tc[tf.reshape(-1)]
    shift = np.repeat(mf, 3).astype(np.float32)
    new_tc[:, 0] = (new_tc[:, 0] + shift) / n
    new_tf = np.arange(len(new_tc)).reshape(-1, 3)

    merged = Material({
        'name': 'merged',
        'bsdf': materials[0].get('bsdf', 'pbr'),
        'kd': Texture2D(kd_atlas),
        'ks': Texture2D(ks_atlas),
    })
    return merged, new_tc, new_tf
