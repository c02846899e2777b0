"""Normalization factory and the NCSN instance norms, channels-last
(B, D, H, W, C).

Counterpart of ``meshdiffusion_tpu/models/normalization.py`` (reference
``lib/diffusion/models/normalization.py``, the factory at :22-40). The
U-Net normalizes with GroupNorm (32 groups, eps 1e-6); the instance norms
serve NCSN-style configs. Parameters keep the JAX package's names
(``gamma``, ``alpha``, ``beta``, ``embed``; GroupNorm's ``weight`` and
``bias`` are flax's ``scale`` and ``bias``), so
``utils.convert.normalization_state_from_jax`` carries a flax tree across.
Statistics are population ones (no Bessel correction), eps 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

_EPS = 1e-5


def get_normalization(config, conditional: bool = False):
    """The norm class for ``config.model.normalization`` (reference
    normalization.py:22-40). Each is built with the channel count:
    ``norm(num_features)``, and the conditional one also ``num_classes``."""
    norm = config.model.normalization
    if conditional:
        if norm == 'InstanceNorm++':
            return ConditionalInstanceNorm3dPlus
        raise NotImplementedError(f'{norm} not implemented yet.')
    if norm == 'InstanceNorm':
        return InstanceNorm3d
    if norm == 'InstanceNorm++':
        return InstanceNorm3dPlus
    if norm == 'GroupNorm':
        return GroupNorm
    raise ValueError('Unknown normalization: %s' % norm)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` (32 groups, eps 1e-6 by default) over a
    channels-last tensor, in fp32 (flax's ``nn.GroupNorm`` as the JAX
    factory builds it: its result takes the wider of the input's and the
    fp32 parameters' dtypes)."""

    def __init__(self, num_features: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__(num_groups, num_features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.movedim(-1, 1).float(), self.num_groups, self.weight, self.bias,
                         self.eps)
        return y.movedim(1, -1).to(torch.promote_types(x.dtype, self.weight.dtype))


def _instance_stats(x: torch.Tensor):
    """x normalized per (sample, channel) over D, H, W, and the
    cross-channel-normalized channel means (B, C) of InstanceNorm++."""
    var, mean = torch.var_mean(x, dim=(1, 2, 3), keepdim=True, correction=0)
    h = (x - mean) / torch.sqrt(var + _EPS)
    means = mean[:, 0, 0, 0]                                  # (B, C)
    v, m = torch.var_mean(means, dim=-1, keepdim=True, correction=0)
    return h, (means - m) / torch.sqrt(v + _EPS)


class InstanceNorm3d(nn.Module):
    """Per-channel instance norm over (D, H, W) with a scale ``gamma`` and,
    when ``bias``, a shift ``beta``."""

    def __init__(self, num_features: int, bias: bool = True):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(num_features))
        self.beta = nn.Parameter(torch.zeros(num_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(x, dim=(1, 2, 3), keepdim=True, correction=0)
        h = (x - mean) / torch.sqrt(var + _EPS) * self.gamma
        return h if self.beta is None else h + self.beta


class InstanceNorm3dPlus(nn.Module):
    """NCSN's InstanceNorm++: the instance norm plus ``alpha`` times the
    channel means normalized across the channels, so that shifts between
    channels survive the normalization."""

    def __init__(self, num_features: int, bias: bool = True):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(num_features))
        self.alpha = nn.Parameter(torch.ones(num_features))
        self.beta = nn.Parameter(torch.zeros(num_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, means_norm = _instance_stats(x)
        h = (h + means_norm[:, None, None, None, :] * self.alpha) * self.gamma
        return h if self.beta is None else h + self.beta


class ConditionalInstanceNorm3dPlus(nn.Module):
    """Class-conditional InstanceNorm++: a class's gamma, alpha and beta
    are its row of ``embed`` (num_classes, 3C; 2C without ``bias``),
    gathered by the integer label ``y`` (B,)."""

    def __init__(self, num_features: int, num_classes: int = 10, bias: bool = True):
        super().__init__()
        self.num_features, self.bias = num_features, bias
        # gamma and alpha start at 1, beta at 0 (the JAX package's init)
        embed = torch.ones(num_classes, (3 if bias else 2) * num_features)
        if bias:
            embed[:, 2 * num_features:] = 0.0
        self.embed = nn.Parameter(embed)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        C = self.num_features
        h, means_norm = _instance_stats(x)
        g = self.embed[y.long()][:, None, None, None, :]         # (B, 1, 1, 1, nC)
        h = (h + means_norm[:, None, None, None, :] * g[..., C:2 * C]) * g[..., :C]
        return h + g[..., 2 * C:] if self.bias else h
