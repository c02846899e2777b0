"""Naive 3D up- and down-sampling, channels-last (B, D, H, W, C).

Counterpart of ``meshdiffusion_tpu/models/up_or_down_sampling.py``
(reference ``lib/diffusion/models/up_or_down_sampling.py``, whose
FIR-filtered paths call a nonexistent ``upfirdn2d``: only the naive
variants can run, and they are what both packages provide).
"""

from __future__ import annotations

import torch


def naive_upsample_3d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsampling by ``factor`` along D, H and W."""
    for dim in (1, 2, 3):
        x = x.repeat_interleave(factor, dim)
    return x


def naive_downsample_3d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Average pooling by ``factor`` along D, H and W."""
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // factor, factor, H // factor, factor, W // factor, factor, C)
    return x.mean(dim=(2, 4, 6))
