"""Split-sum environment light with cubemap filtering.

Counterpart of ``meshdiffusion_tpu/render/light.py`` (reference
``nvdiffrec/lib/render/light.py``: EnvironmentLight:45-142, the HDR
loader:149-172, and the filters of ``renderutils/c_src/cubemap.cu``):

* the mip chain is iterated 2x average pooling down to LIGHT_MIN_RES;
* the cosine-weighted irradiance at that level is one exact
  (6*16^2) x (6*16^2) texel-to-texel matmul;
* GGX prefiltering (``build_mips(with_specular=True)``) is the same full
  contraction per mip level, in row chunks.

Autograd supplies every backward, so a trainable base cubemap
(``learn_light``) works unchanged. The shader is diffuse only: specular
split-sum shading raises, as the JAX package's and the reference's do.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from . import utils

LIGHT_MIN_RES = 16
MIN_ROUGHNESS = 0.08
MAX_ROUGHNESS = 0.5


def _texel_dirs_weights(res: int, device=None):
    """Unit directions + solid-angle weights for all 6*res*res cubemap texels."""
    gx, gy = utils._face_grid((res, res), device)
    dirs, weights = [], []
    for s in range(6):
        v = utils.cube_to_dir(s, gx, gy)
        norm2 = torch.sum(v * v, dim=-1)
        # solid angle of a cube-face texel: 4/res^2 / |v|^3 (pre-normalization)
        weights.append((2.0 / res) ** 2 / torch.pow(norm2, 1.5))
        dirs.append(v / torch.sqrt(norm2)[..., None])
    return torch.stack(dirs).reshape(-1, 3), torch.stack(weights).reshape(-1)


def diffuse_cubemap(cubemap: torch.Tensor) -> torch.Tensor:
    """Cosine-convolved irradiance: out(n) = sum_i max(n.d_i, 0) w_i L_i /
    sum_i max(n.d_i, 0) w_i over every texel i."""
    dirs, w = _texel_dirs_weights(cubemap.shape[1], cubemap.device)
    L = cubemap.reshape(-1, cubemap.shape[-1])
    cw = torch.clamp(dirs @ dirs.T, min=0.0) * w[None, :]
    return ((cw @ L) / torch.sum(cw, dim=1, keepdim=True)).reshape(cubemap.shape)


def _ggx_ndf(alpha_sqr, cos_theta):
    c = torch.clamp(cos_theta, 1e-4, 1.0)
    d = (c * alpha_sqr - c) * c + 1
    return alpha_sqr / (d * d * np.pi)


def specular_cubemap(cubemap: torch.Tensor, roughness: float, cutoff: float = 0.99,
                     chunk: int = 2048) -> torch.Tensor:
    """GGX-prefiltered cubemap (reference cubemap.cu SpecularCubemapKernel):
    out(r) = sum_i D_ggx(r.d_i) (r.d_i)^+ w_i L_i / the same sum without
    L_i, every texel i, in row chunks of ``chunk`` directions."""
    dirs, w = _texel_dirs_weights(cubemap.shape[1], cubemap.device)
    L = cubemap.reshape(-1, cubemap.shape[-1])
    alpha = roughness * roughness
    alpha_sqr = alpha * alpha
    outs = []
    for s in range(0, dirs.shape[0], chunk):
        cos = torch.clamp(dirs[s:s + chunk] @ dirs.T, min=0.0)
        k = _ggx_ndf(alpha_sqr, cos) * w[None, :] * cos
        outs.append((k @ L) / torch.clamp(torch.sum(k, dim=1, keepdim=True), min=1e-8))
    return torch.cat(outs, dim=0).reshape(cubemap.shape)


def cubemap_mip(cubemap: torch.Tensor) -> torch.Tensor:
    """One mip level: 2x average pooling of each face (reference
    light.py:24-39; backward by autograd)."""
    return utils.avg_pool_nhwc(cubemap, 2)


class EnvironmentLight:
    """A 6 x H x W x 3 cubemap light; ``base`` may require grad."""

    def __init__(self, base: torch.Tensor, trainable: bool = True):
        self.base = base
        self.trainable = trainable
        self.diffuse: Optional[torch.Tensor] = None
        self.specular: List[torch.Tensor] = []
        self.mtx = None

    def xfm(self, mtx) -> None:
        self.mtx = mtx

    def clone(self) -> "EnvironmentLight":
        return EnvironmentLight(self.base, self.trainable)

    def clamp(self, min=None, max=None) -> None:
        self.base = torch.clamp(self.base, min, max)

    def get_mip(self, roughness: torch.Tensor) -> torch.Tensor:
        """The specular mip level (fractional) of each roughness."""
        n = len(self.specular)
        return torch.where(
            roughness < MAX_ROUGHNESS,
            (torch.clamp(roughness, MIN_ROUGHNESS, MAX_ROUGHNESS) - MIN_ROUGHNESS)
            / (MAX_ROUGHNESS - MIN_ROUGHNESS) * (n - 2),
            (torch.clamp(roughness, MAX_ROUGHNESS, 1.0) - MAX_ROUGHNESS)
            / (1.0 - MAX_ROUGHNESS) + n - 2)

    def build_mips(self, cutoff: float = 0.99, with_specular: bool = False) -> None:
        """The mip chain down to LIGHT_MIN_RES and the diffuse irradiance
        map; with ``with_specular`` the GGX-prefiltered chain in
        ``specular`` (else the plain chain), as the JAX package keeps it
        (the reference always prefilters, light.py:73-83, but the shader
        reads only the diffuse map)."""
        chain = [self.base]
        while chain[-1].shape[1] > LIGHT_MIN_RES:
            chain.append(cubemap_mip(chain[-1]))
        self.diffuse = diffuse_cubemap(chain[-1])
        if with_specular:
            spec = []
            for idx in range(len(chain) - 1):
                r = (idx / (len(chain) - 2)) * (MAX_ROUGHNESS - MIN_ROUGHNESS) + MIN_ROUGHNESS
                spec.append(specular_cubemap(chain[idx], r, cutoff))
            spec.append(specular_cubemap(chain[-1], 1.0, cutoff))
            self.specular = spec
        else:
            self.specular = chain

    def regularizer(self) -> torch.Tensor:
        white = torch.mean(self.base, dim=-1, keepdim=True)
        return torch.mean(torch.abs(self.base - white))

    def shade(self, gb_pos, gb_normal, kd, ks, view_pos, specular=False, xfm_lgt=None):
        """Diffuse shading (reference light.py:89-142, which also raises on
        the specular path MeshDiffusion never takes): the normals turned by
        ``xfm_lgt`` (B, 4, 4) when given, one image of the batch a matrix."""
        from . import ops
        nrmvec = gb_normal
        if xfm_lgt is not None:
            m = torch.as_tensor(xfm_lgt, dtype=torch.float32, device=nrmvec.device)
            lead = nrmvec.shape[:-1]
            nrmvec = ops.xfm_vectors(nrmvec.reshape(lead[0], -1, 3), m).reshape(lead + (3,))
        shaded_col = utils.sample_cubemap(self.diffuse, nrmvec) * kd
        if specular:
            raise NotImplementedError('specular split-sum shading (the reference raises too, '
                                      'light.py:124-125)')
        return shaded_col * (1.0 - ks[..., 0:1])


def load_env(fn: str, scale: float = 1.0, trainable: bool = True,
             device=None) -> EnvironmentLight:
    """HDR latlong -> 512^2 cubemap light with its mips on ``device``
    (reference light.py:149-172)."""
    ext = os.path.splitext(fn)[1].lower()
    if ext != '.hdr':
        raise ValueError(f'Unknown envlight extension {ext}')
    latlong = torch.as_tensor(utils.load_image(fn), dtype=torch.float32, device=device) * scale
    light = EnvironmentLight(utils.latlong_to_cubemap(latlong, (512, 512)), trainable=trainable)
    light.build_mips()
    return light


def create_trainable_env_rnd(base_res: int, scale: float = 0.5, bias: float = 0.25,
                             generator: Optional[torch.Generator] = None,
                             device=None) -> EnvironmentLight:
    """Uniform-random cubemap light (reference light.py create_trainable_env_rnd).
    The fitting path calls it with scale 0, a constant ``bias`` light."""
    base = torch.rand((6, base_res, base_res, 3), generator=generator,
                      device=device) * scale + bias
    return EnvironmentLight(base)
