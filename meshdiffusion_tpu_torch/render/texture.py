"""2D textures with mip chains and trilinear sampling.

Counterpart of ``meshdiffusion_tpu/render/texture.py`` (reference
``nvdiffrec/lib/render/texture.py``: Texture2D:40-101,
create_trainable:108-135, the sRGB converters:141-145, file I/O:151-188)
without nvdiffrast: sampling is bilinear gathers with wrap addressing
(floor-mod), and the mips come from iterated 2x average pooling, so the
gradient of the base texture flows through the pooling chain by autograd.

A texture is one NHWC tensor (mips made on demand) or an explicit list
of mips, with an optional ``min_max`` range for :meth:`Texture2D.clamp`.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from . import utils


def _to_nhwc(init) -> torch.Tensor:
    x = torch.as_tensor(init, dtype=torch.float32)
    if x.ndim == 1:
        x = x[None, None, None, :]
    elif x.ndim == 3:
        x = x[None]
    assert x.ndim == 4, x.shape
    return x


class Texture2D:
    """A texture: a single NHWC tensor (automatic mips) or a list of mips."""

    def __init__(self, init, min_max=None):
        if isinstance(init, Texture2D):
            self.data = init.data
            self.min_max = init.min_max if min_max is None else min_max
            return
        if isinstance(init, (list, tuple)) and len(init) == 1:
            init = init[0]
        if isinstance(init, (list, tuple)):
            self.data = [_to_nhwc(m) for m in init]
        else:
            self.data = _to_nhwc(init)
        self.min_max = min_max

    def get_mips(self) -> List[torch.Tensor]:
        if isinstance(self.data, list):
            return list(self.data)
        mips = [self.data]
        while mips[-1].shape[1] > 1 and mips[-1].shape[2] > 1:
            mips.append(utils.avg_pool_nhwc(mips[-1], 2))
        return mips

    @property
    def res(self):
        return tuple(self.get_mips()[0].shape[1:3])

    @property
    def channels(self):
        return self.get_mips()[0].shape[3]

    def to(self, device) -> "Texture2D":
        out = Texture2D.__new__(Texture2D)
        out.data = ([m.to(device) for m in self.data] if isinstance(self.data, list)
                    else self.data.to(device))
        out.min_max = self.min_max
        return out

    def clamp(self) -> "Texture2D":
        """The texture clipped to ``min_max`` (reference texture.py:91-95),
        a new texture."""
        if self.min_max is None:
            return self
        lo, hi = (torch.as_tensor(np.asarray(m), dtype=torch.float32) for m in self.min_max)
        clip = lambda m: torch.clamp(m, lo.to(m.device), hi.to(m.device))
        out = Texture2D.__new__(Texture2D)
        out.data = ([clip(m) for m in self.data] if isinstance(self.data, list)
                    else clip(self.data))
        out.min_max = self.min_max
        return out

    def sample(self, texc: torch.Tensor, texc_deriv: Optional[torch.Tensor] = None,
               filter_mode: str = 'linear-mipmap-linear') -> torch.Tensor:
        """Sample at (..., 2) uv; trilinear across the mips when uv
        derivatives (du/dx, du/dy[, dv/dx, dv/dy]) are given (nvdiffrast
        ``dr.texture`` with wrap boundaries)."""
        mips = self.get_mips()
        if (filter_mode == 'linear' or texc_deriv is None or len(mips) == 1
                or mips[0].shape[1] == 1):
            return _sample_mip(mips[0], texc)

        # the mip level from the uv footprint in texels
        H, W = mips[0].shape[1], mips[0].shape[2]
        du = texc_deriv[..., 0:2]
        dv = texc_deriv[..., 2:4] if texc_deriv.shape[-1] >= 4 else du
        fx = torch.maximum(du[..., 0].abs() * W, dv[..., 0].abs() * W)
        fy = torch.maximum(du[..., 1].abs() * H, dv[..., 1].abs() * H)
        rho = torch.clamp(torch.maximum(fx, fy), min=1e-8)
        lod = torch.clamp(torch.log2(rho), 0.0, len(mips) - 1 - 1e-4)
        lo = torch.floor(lod).long()
        frac = (lod - lo)[..., None]

        samples = torch.stack([_sample_mip(m, texc) for m in mips])       # (L, ..., C)
        s_lo = torch.gather(samples, 0, lo[None, ..., None].expand((1,) + samples.shape[1:]))[0]
        hi = torch.clamp(lo + 1, 0, len(mips) - 1)
        s_hi = torch.gather(samples, 0, hi[None, ..., None].expand((1,) + samples.shape[1:]))[0]
        return s_lo * (1 - frac) + s_hi * frac


def _sample_mip(mip: torch.Tensor, texc: torch.Tensor) -> torch.Tensor:
    """Bilinear wrap-mode sample of a (1, H, W, C) mip at (..., 2) uv."""
    img = mip[0]
    H, W = img.shape[0], img.shape[1]
    u = texc[..., 0] * W - 0.5
    v = texc[..., 1] * H - 0.5
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0 = torch.remainder(x0.long(), W)
    y0 = torch.remainder(y0.long(), H)
    x1 = torch.remainder(x0 + 1, W)
    y1 = torch.remainder(y0 + 1, H)
    a = img[y0, x0]
    b = img[y0, x1]
    c = img[y1, x0]
    d = img[y1, x1]
    return (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
            + c * (1 - fx) * fy + d * fx * fy)


def create_trainable(init, res=None, auto_mipmaps=True, min_max=None) -> Texture2D:
    """Reference texture.py:108-135: the texture resized to ``res``, with
    automatic mips or an explicit chain resized level by level."""
    if isinstance(init, Texture2D):
        min_max = init.min_max if min_max is None else min_max
        init = init.data
    x = _to_nhwc(init)
    if res is not None:
        x = utils.scale_img_nhwc(x, res)
    if not auto_mipmaps:
        chain = [x]
        while chain[-1].shape[1] > 1 or chain[-1].shape[2] > 1:
            new = (max(chain[-1].shape[1] // 2, 1), max(chain[-1].shape[2] // 2, 1))
            chain.append(utils.scale_img_nhwc(chain[-1], new))
        return Texture2D(chain, min_max=min_max)
    return Texture2D(x, min_max=min_max)


def srgb_to_rgb(texture: Texture2D) -> Texture2D:
    return Texture2D([utils.srgb_to_rgb(m) for m in texture.get_mips()])


def rgb_to_srgb(texture: Texture2D) -> Texture2D:
    return Texture2D([utils.rgb_to_srgb(m) for m in texture.get_mips()])


def load_texture2D(fn: str, lambda_fn=None, channels=None) -> Texture2D:
    img = torch.as_tensor(utils.load_image(fn), dtype=torch.float32)
    if channels is not None:
        img = img[..., 0:channels]
    if lambda_fn is not None:
        img = lambda_fn(img)
    return Texture2D(img)


def save_texture2D(fn: str, tex: Texture2D, lambda_fn=None) -> None:
    """Write the base texture to ``fn``, or every mip of an explicit chain
    to ``{base}_{i}{ext}``."""
    if isinstance(tex.data, list):
        base, ext = os.path.splitext(fn)
        for i, mip in enumerate(tex.data):
            data = (lambda_fn(mip) if lambda_fn else mip)[0]
            utils.save_image(f'{base}_{i}{ext}', data.detach().cpu().numpy())
    else:
        data = (lambda_fn(tex.data) if lambda_fn else tex.data)[0]
        utils.save_image(fn, data.detach().cpu().numpy())
