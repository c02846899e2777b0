"""NCSN refinement blocks (the 3D RefineNet family), channels-last
(B, D, H, W, C).

Counterpart of ``meshdiffusion_tpu/models/ncsn_blocks.py`` (reference
``lib/diffusion/models/layers.py``: CRPBlock:160, RCUBlock:210,
MSFBlock:261, RefineBlock:304, the pooled convs from :378). MeshDiffusion's
U-Net does not use them; the reference ships them for NCSN-style configs.
The convs are plain ``F.conv3d`` with SAME padding, weights in the torch
layout (O, I, kd, kh, kw) and flax's lecun-normal init; the submodules keep
the JAX package's names (``conv_0``, ``adapt_1``, ``msf``, ...), so
``utils.convert.ncsn_block_state_from_jax`` carries a flax tree across. A
torch module is built with its input widths, which flax reads from the
input: ``in_planes`` where a block takes inputs of other widths.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv3d(nn.Module):
    """A SAME k^3 conv (stride 1) of channels-last tensors (flax's
    ``nn.Conv(features, (k, k, k), padding='SAME')``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, use_bias: bool = True):
        super().__init__()
        self.kernel = kernel
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None
        # lecun_normal: a normal truncated at 2 sigma, of variance 1 / fan_in
        std = math.sqrt(1.0 / (in_ch * kernel ** 3)) / 0.87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = (self.kernel - 1) // 2, self.kernel // 2     # SAME: the extra pad goes last
        h = F.pad(x.movedim(-1, 1), (lo, hi) * 3)
        return F.conv3d(h, self.weight, self.bias).movedim(1, -1)


def _pool5(x: torch.Tensor, maxpool: bool) -> torch.Tensor:
    """5^3 SAME pooling, stride 1: the max over the window, or its mean
    with the padding counted (flax's ``avg_pool``)."""
    h = x.movedim(-1, 1)
    h = F.max_pool3d(h, 5, 1, 2) if maxpool else F.avg_pool3d(h, 5, 1, 2, count_include_pad=True)
    return h.movedim(1, -1)


def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(..., 'linear')`` along
    one axis: the triangle kernel at half-pixel centres, widened by the
    factor when downsampling (antialias), each column normalized, zero for
    a sample outside the input."""
    inv_scale = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None])
    w = torch.relu(1.0 - dist.abs() / max(inv_scale, 1.0))
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_linear(x: torch.Tensor, shape: Tuple[int, int, int]) -> torch.Tensor:
    """Trilinear resize of (B, D, H, W, C) to the spatial ``shape``, as
    ``jax.image.resize(x, (B, *shape, C), 'linear')``: each axis whose
    size changes is contracted with its weight matrix."""
    for dim, n_out in zip((1, 2, 3), shape):
        n_in = x.shape[dim]
        if n_in != n_out:
            w = _linear_weights(n_in, n_out, x.device).to(x.dtype)
            x = torch.matmul(x.movedim(dim, -1), w).movedim(-1, dim)
    return x


class CRPBlock(nn.Module):
    """Chained residual pooling (reference layers.py:160-181): ``n_stages``
    times pool then conv, each stage's output added to the input."""

    def __init__(self, features: int, n_stages: int = 2, act: Callable = F.relu,
                 maxpool: bool = True):
        super().__init__()
        self.n_stages, self.act, self.maxpool = n_stages, act, maxpool
        for i in range(n_stages):
            self.add_module(f'conv_{i}', Conv3d(features, features, use_bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(x)
        path = x
        for i in range(self.n_stages):
            path = getattr(self, f'conv_{i}')(_pool5(path, self.maxpool))
            x = path + x
        return x


class RCUBlock(nn.Module):
    """Residual conv units (reference layers.py:210-231): ``n_blocks``
    residual units of ``n_stages`` act -> conv each."""

    def __init__(self, features: int, n_blocks: int = 2, n_stages: int = 2,
                 act: Callable = F.relu):
        super().__init__()
        self.n_blocks, self.n_stages, self.act = n_blocks, n_stages, act
        for i in range(n_blocks):
            for j in range(n_stages):
                self.add_module(f'conv_{i}_{j}', Conv3d(features, features, use_bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f'conv_{i}_{j}')(self.act(x))
            x = x + residual
        return x


class MSFBlock(nn.Module):
    """Multi-scale fusion (reference layers.py:261-277): each input of
    width ``in_planes[i]`` through a conv (with bias) to ``features``,
    resized trilinearly to ``shape``, summed."""

    def __init__(self, in_planes: Sequence[int], features: int):
        super().__init__()
        self.n = len(in_planes)
        for i, c in enumerate(in_planes):
            self.add_module(f'conv_{i}', Conv3d(c, features))

    def forward(self, xs: Sequence[torch.Tensor], shape: Tuple[int, int, int]) -> torch.Tensor:
        out = None
        for i, x in enumerate(xs):
            h = resize_linear(getattr(self, f'conv_{i}')(x), shape)
            out = h if out is None else out + h
        return out


class RefineBlock(nn.Module):
    """RefineNet block (reference layers.py:304-337): an RCU on each input
    (``adapt_i``, its own width), the multi-scale fusion when there are
    several, chained residual pooling, output RCUs (3 when ``end``)."""

    def __init__(self, in_planes: Sequence[int], features: int, act: Callable = F.relu,
                 start: bool = False, end: bool = False, maxpool: bool = True):
        super().__init__()
        for i, c in enumerate(in_planes):
            self.add_module(f'adapt_{i}', RCUBlock(c, 2, 2, act))
        if len(in_planes) > 1:
            self.msf = MSFBlock(in_planes, features)
        self.crp = CRPBlock(features, 2, act, maxpool)
        self.out_rcu = RCUBlock(features, 3 if end else 1, 2, act)

    def forward(self, xs: Sequence[torch.Tensor],
                output_shape: Tuple[int, int, int]) -> torch.Tensor:
        hs = [getattr(self, f'adapt_{i}')(x) for i, x in enumerate(xs)]
        h = self.msf(hs, output_shape) if len(xs) > 1 else hs[0]
        return self.out_rcu(self.crp(h))


def _mean_pool_hw(x: torch.Tensor) -> torch.Tensor:
    """2x mean pooling over H and W (D kept), in the JAX package's order."""
    return (x[:, :, ::2, ::2] + x[:, :, 1::2, ::2] + x[:, :, ::2, 1::2] + x[:, :, 1::2, 1::2]) / 4.0


class ConvMeanPool(nn.Module):
    """A SAME conv, then 2x mean pooling over H and W (reference
    layers.py:378-396)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, use_bias: bool = True):
        super().__init__()
        self.conv = Conv3d(in_ch, features, kernel, use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _mean_pool_hw(self.conv(x))


class MeanPoolConv(nn.Module):
    """2x mean pooling over H and W, then a SAME conv (reference
    layers.py:399+)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, use_bias: bool = True):
        super().__init__()
        self.conv = Conv3d(in_ch, features, kernel, use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(_mean_pool_hw(x))
