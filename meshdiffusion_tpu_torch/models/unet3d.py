"""3D U-Net score network (DDPM-style), channels-last.

Counterpart of ``meshdiffusion_tpu/models/unet3d.py`` (reference
``ddpm_res64.py`` / ``ddpm_res128.py``). The module tree keeps the
reference torch layout: a flat ``all_modules`` list in construction order
plus the ``pos_layer`` and ``mask_layer`` stem convs, so that
``meshdiffusion_tpu.utils.torch_convert.module_walk`` names every
parameter and the released ``.pth`` weights map onto it key for key.
res128 has no ``pos_layer`` (its forward never uses the reference's
dormant one).

* res64: 3^3 stem/output convs, a zeroed coordinate volume through
  ``pos_layer`` (whose output is therefore its bias), the same block count
  at every level.
* res128: 5^3 stem/output convs, no coordinates, level 0 fixed at
  ``num_res_blocks_first`` blocks.

Under ``parallel.spatial.sharded`` x and the mask are this rank's depth
slab of the grid (see ``models/layers.py``); the stem, the mask and output
convs read their neighbours' planes (2 at res128's 5^3), and the output
head normalises with the whole grid's statistics. The deepest level's
depth, R / 2^(L-1), must split evenly over the slabs.

The output head's GroupNorm+SiLU is ``ops.groupnorm_silu``, which, as the
ResnetBlocks' ops, takes its route by the rule of ``ops/_build.py`` (under
autograd its plain version: the Triton apply has no backward);
``ops.plain()`` makes every op of a forward take its plain version, which
is how the plain comparisons on the card are built.

``forward(..., train=True)`` is the training forward, as the JAX package's
``train`` argument: dropout in every ResnetBlock and each ResnetBlock
under ``torch.utils.checkpoint`` (its internals recomputed
in the backward, the dropout mask too, from the saved RNG state): training
at res64 needs it to fit a micro-batch. ``gpu.remat_blocks`` (the
``remat_blocks`` argument; the JAX package's ``tpu.remat_blocks``) False
keeps every block's activations instead. ``nn.Module.training`` plays no
part.

A forward is a ``unet.forward`` span, each ResnetBlock's a ``unet.resblock``
and each attention block's a ``unet.attn`` span (``utils/trace.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import ops
from ..parallel import spatial
from ..utils import trace
from . import layers
from .registry import register_alias, register_model


class UNet3D(nn.Module):
    """DDPM 3D U-Net over (B, R, R, R, C) grids."""

    def __init__(self, image_size: int = 64, channels: int = 4, nf: int = 128,
                 ch_mult: Tuple[int, ...] = (1, 1, 2, 4, 4), num_res_blocks: int = 3,
                 num_res_blocks_first: Optional[int] = None,
                 attn_resolutions: Tuple[int, ...] = (16,), resamp_with_conv: bool = True,
                 conditional: bool = True, centered: bool = True, stem_kernel: int = 3,
                 use_coords: bool = True, scale_by_sigma: bool = False,
                 sigma_min: float = 0.01, sigma_max: float = 378.0, num_scales: int = 1000,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1,
                 remat_blocks: bool = True):
        super().__init__()
        self.image_size, self.channels, self.nf = image_size, channels, nf
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks, self.num_res_blocks_first = num_res_blocks, num_res_blocks_first
        self.attn_resolutions = tuple(attn_resolutions)
        self.conditional, self.centered = conditional, centered
        self.use_coords, self.scale_by_sigma = use_coords, scale_by_sigma
        self.sigma_min, self.sigma_max, self.num_scales = sigma_min, sigma_max, num_scales
        self.dtype = dtype
        self.remat_blocks = remat_blocks
        dt, k = dtype, stem_kernel
        L = len(self.ch_mult)
        res = [image_size // (2 ** i) for i in range(L)]
        temb_dim = 4 * nf if conditional else None

        def resblock(cin, cout):
            return layers.ResnetBlockDDPM(cin, cout, temb_dim, dtype=dt, dropout=dropout)

        if use_coords:
            self.pos_layer = layers.Conv3D(3, nf, k, dtype=dt)
        self.mask_layer = layers.Conv3D(1, nf, k, dtype=dt)

        mods = []
        if conditional:
            mods += [nn.Linear(nf, 4 * nf), nn.Linear(4 * nf, 4 * nf)]
        mods.append(layers.Conv3D(channels, nf, k, dtype=dt))          # stem
        hs_c = [nf]
        in_ch = nf
        for lev in range(L):
            for _ in range(self.level_blocks(lev)):
                out_ch = nf * self.ch_mult[lev]
                mods.append(resblock(in_ch, out_ch))
                in_ch = out_ch
                if res[lev] in self.attn_resolutions:
                    mods.append(layers.AttnBlock(in_ch, dtype=dt))
                hs_c.append(in_ch)
            if lev != L - 1:
                mods.append(layers.Downsample(in_ch, resamp_with_conv, dtype=dt))
                hs_c.append(in_ch)
        mods += [resblock(in_ch, in_ch), layers.AttnBlock(in_ch, dtype=dt),
                 resblock(in_ch, in_ch)]
        for lev in reversed(range(L)):
            for _ in range(self.level_blocks(lev) + 1):
                out_ch = nf * self.ch_mult[lev]
                mods.append(resblock(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if res[lev] in self.attn_resolutions:
                mods.append(layers.AttnBlock(in_ch, dtype=dt))
            if lev != 0:
                mods.append(layers.Upsample(in_ch, resamp_with_conv, dtype=dt))
        assert not hs_c
        mods += [nn.GroupNorm(32, in_ch, eps=1e-6),                    # out_norm
                 layers.Conv3D(in_ch, channels, k, init_scale=0.0, dtype=dt)]  # out_conv
        self.all_modules = nn.ModuleList(mods)

    @classmethod
    def from_config(cls, config, **overrides) -> "UNet3D":
        m = config.model
        is_128 = 'res128' in m.name
        kw = dict(
            image_size=config.data.image_size, channels=config.data.num_channels,
            nf=m.nf, ch_mult=tuple(m.ch_mult), num_res_blocks=m.num_res_blocks,
            num_res_blocks_first=m.get('num_res_blocks_first') if is_128 else None,
            attn_resolutions=tuple(m.attn_resolutions),
            resamp_with_conv=m.resamp_with_conv, conditional=m.conditional,
            centered=config.data.centered, stem_kernel=5 if is_128 else 3,
            use_coords=not is_128, scale_by_sigma=m.scale_by_sigma,
            sigma_min=m.sigma_min, sigma_max=m.sigma_max, num_scales=m.num_scales,
            dtype=getattr(torch, config.gpu.compute_dtype), dropout=m.dropout,
            remat_blocks=bool(config.gpu.remat_blocks))
        kw.update(overrides)
        return cls(**kw)

    def level_blocks(self, i_level: int) -> int:
        if i_level == 0 and self.num_res_blocks_first is not None:
            return self.num_res_blocks_first
        return self.num_res_blocks

    def reset_parameters_ddpm(self, generator: Optional[torch.Generator] = None) -> None:
        """The DDPM initialisation of the JAX package (variance_scaling
        fan_avg uniform; zero-scale for each block's last conv, the
        attention output NIN and the output conv; zero biases; unit
        GroupNorm scales), drawn from ``generator``."""
        for mod in self.modules():
            if isinstance(mod, (layers.Conv3D, layers.NIN)):
                mod.reset_parameters_ddpm(generator)
            elif isinstance(mod, nn.Linear):
                layers.ddpm_init_(mod.weight, mod.in_features, mod.out_features, 1.0, generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.GroupNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    @trace.span('unet.forward')
    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                mask: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        """x: (B, R, R, R, C) channels-last. labels: (B,) float timestep
        labels in [0, num_scales-1]. mask: (1, R, R, R, 1) grid mask.
        ``train``: the training forward (dropout, remat). Returns the fp32
        epsilon prediction, channels-last."""
        assert x.ndim == 5 and x.shape[-1] == self.channels
        dt = self.dtype
        L = len(self.ch_mult)
        res = [self.image_size // (2 ** i) for i in range(L)]
        sh = spatial.current()
        if sh is not None and (res[-1] % sh.size or x.shape[1] * sh.size != self.image_size):
            raise ValueError(f'a grid of depth {self.image_size} (the deepest level '
                             f'{res[-1]}) does not split over {sh.size} slabs of {x.shape[1]}')
        mods = iter(self.all_modules)

        def resblock(h, temb):
            block = next(mods)
            if train and self.remat_blocks:
                return checkpoint(block, h, temb, True, use_reentrant=False)
            return block(h, temb, train)

        temb = None
        if self.conditional:
            temb = layers.get_timestep_embedding(labels, self.nf)
            temb = next(mods)(temb)
            temb = next(mods)(F.silu(temb))

        # the conv kernel takes contiguous channels-last tensors: any strides in
        x = x.contiguous()
        h = x if self.centered else 2 * x - 1.0
        stem = next(mods)(h.to(dt))
        if self.use_coords:
            # the reference zeroes the coordinate volume, so pos_layer's
            # output is its bias at every voxel
            stem = stem + self.pos_layer.bias.to(dt)
        if mask is None:
            mask = torch.zeros((1,) + tuple(x.shape[1:4]) + (1,), dtype=dt, device=x.device)
        stem = stem + self.mask_layer(mask.to(dt))

        hs = [stem]
        for lev in range(L):
            for _ in range(self.level_blocks(lev)):
                h = resblock(hs[-1], temb)
                if res[lev] in self.attn_resolutions:
                    h = next(mods)(h)
                hs.append(h)
            if lev != L - 1:
                hs.append(next(mods)(hs[-1]))

        h = resblock(hs[-1], temb)
        h = next(mods)(h)
        h = resblock(h, temb)

        for lev in reversed(range(L)):
            for _ in range(self.level_blocks(lev) + 1):
                skip = hs.pop()
                dtc = torch.promote_types(h.dtype, skip.dtype)
                h = resblock(torch.cat([h.to(dtc), skip.to(dtc)], dim=-1), temb)
            if res[lev] in self.attn_resolutions:
                h = next(mods)(h)
            if lev != 0:
                h = next(mods)(h)
        assert not hs

        norm = next(mods)
        if sh is not None:
            h = spatial.groupnorm(h, norm, silu=True)
        else:
            h = ops.groupnorm_silu(h.contiguous(), norm.weight, norm.bias, 32, 1e-6)
        h = next(mods)(h).float()

        if self.scale_by_sigma:
            sigmas = torch.as_tensor(np.exp(np.linspace(
                np.log(self.sigma_max), np.log(self.sigma_min), self.num_scales)),
                dtype=torch.float32, device=h.device)
            h = h / sigmas[labels.long()][:, None, None, None, None]
        return h


@register_model(name='ddpm_res64')
class DDPMRes64(UNet3D):
    """res64 variant (reference ddpm_res64.py:39)."""


@register_model(name='ddpm_res128')
class DDPMRes128(UNet3D):
    """res128 variant (reference ddpm_res128.py:41)."""

    @classmethod
    def from_config(cls, config, **overrides):
        overrides.setdefault('stem_kernel', 5)
        overrides.setdefault('use_coords', False)
        return super().from_config(config, **overrides)


# The reference config names 'ddpm_res128_v2' but registers only
# 'ddpm_res128' (reference configs/res128.py:40 vs ddpm_res128.py:41).
register_alias('ddpm_res128_v2', 'ddpm_res128')
