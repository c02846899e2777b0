"""Neural 3D texture: a multiresolution hash-grid encoding and a small MLP.

Counterpart of ``meshdiffusion_tpu/render/mlptexture.py`` (reference
``nvdiffrec/lib/render/mlptexture.py:47-104``, which wraps tiny-cuda-nn's
HashGrid and FullyFusedMLP). The JAX package computes the encoding in
plain jnp (integer spatial hash, gather, trilinear blend per level), so
plain torch is its faithful counterpart here: one gather of every level's
eight corners from the flattened table, whose backward is one index_add
into it. The module carries its parameters, so it is also the JAX
package's ``BoundTexture3D``, whose ``sample`` it has.

The hash is instant-ngp's, ``(c0 * p0) ^ (c1 * p1) ^ (c2 * p2)`` in
uint32 arithmetic, then ``% T``. Torch has no full uint32 arithmetic, so
the products are taken in int64 (c <= 4096 and p < 2^32 keep them below
2^44) and masked to 32 bits: the indices equal JAX's exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

_PRIMES = (1, 2654435761, 805459861)


def hash_corners(x: torch.Tensor, resolutions, T: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lattice corners of every level at once: x (N, 3) in [0, 1],
    resolutions (L,) ints -> their table rows (L, 8, N) int64 (level l's
    offset by l * T) and trilinear weights (L, 8, N), corner
    k = o0 + 2 o1 + 4 o2 as in JAX's loop. Each axis has two lattice
    coordinates a point (lower, upper, clipped to [0, res]), hashed and
    weighted once; the eight corners are their XORs and products by
    broadcasting."""
    L = len(resolutions)
    res = torch.as_tensor(np.asarray(resolutions, np.int64), device=x.device)
    xs = x.t()[None] * res.to(x.dtype)[:, None, None]                    # (L, 3, N)
    x0 = torch.floor(xs)
    frac = xs - x0
    lo = x0.long()
    c = torch.minimum(torch.stack((lo, lo + 1), dim=2).clamp_(min=0),
                      res[:, None, None, None])                           # (L, 3, 2, N)
    h = (c * torch.tensor(_PRIMES, device=x.device)[None, :, None, None]) & 0xFFFFFFFF
    idx = h[:, 2, :, None, None] ^ h[:, 1, None, :, None] ^ h[:, 0, None, None, :]
    idx = torch.remainder(idx, T) + torch.arange(L, device=x.device)[:, None, None, None, None] * T
    w = torch.stack((1.0 - frac, frac), dim=2)                            # (L, 3, 2, N)
    wts = (w[:, 0, None, None, :] * w[:, 1, None, :, None]) * w[:, 2, :, None, None]
    return idx.reshape(L, 8, -1), wts.reshape(L, 8, -1)


def hash_encode(x: torch.Tensor, table: torch.Tensor, resolutions) -> torch.Tensor:
    """Multilevel hash encoding: x (N, 3) in [0, 1], table (L, T, F),
    resolutions (L,) ints -> (N, L*F), level-major. The rows of every level
    and corner are read by one gather from the flattened table, so the
    backward is one index_add into it: a call is a few dozen kernels
    whatever L is (the fit samples it 16 times a step)."""
    L, T, F = table.shape
    N = x.shape[0]
    idx, wts = hash_corners(x, resolutions, T)
    rows = table.reshape(L * T, F).index_select(0, idx.reshape(-1))
    feat = (rows.view(L, 8, N, F) * wts.view(L, 8, N, 1)).sum(dim=1)
    return feat.permute(1, 0, 2).reshape(N, L * F)


class HashEncoder(nn.Module):
    """instant-ngp style hash grid: 16 levels, 2 features, 2^19 entries a
    level, resolutions 16 -> 4096 (reference mlptexture.py:57-69). The
    table starts uniform in [-1e-4, 1e-4)."""

    def __init__(self, num_levels: int = 16, features_per_level: int = 2,
                 log2_hashmap_size: int = 19, base_resolution: int = 16,
                 desired_resolution: int = 4096, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.num_levels = num_levels
        self.features_per_level = features_per_level
        self.base_resolution = base_resolution
        self.desired_resolution = desired_resolution
        T = 2 ** log2_hashmap_size
        table = torch.rand((num_levels, T, features_per_level), generator=generator,
                           device=device) * 2e-4 - 1e-4
        self.table = nn.Parameter(table)

    def resolutions(self) -> np.ndarray:
        g = np.exp(np.log(self.desired_resolution / self.base_resolution)
                   / (self.num_levels - 1))
        return np.round(self.base_resolution * g ** np.arange(self.num_levels)).astype(np.int64)

    @property
    def n_output_dims(self) -> int:
        return self.num_levels * self.features_per_level

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hash_encode(x, self.table, self.resolutions())


class MLPTexture3D(nn.Module):
    """Hash-encoded neural 3D texture (reference mlptexture.py:47-104):
    positions normalized to ``aabb`` and clipped to [0, 1], the encoder,
    ``hidden`` ReLU layers of ``internal_dims``, a linear output of
    ``channels``, sigmoid-mapped into ``min_max`` when given. No layer has
    a bias; the layers start Kaiming-uniform (fan in), as flax's
    variance_scaling(2, 'fan_in', 'uniform') does.

    Parameter names follow the JAX tree: ``encoder.table`` and
    ``dense_{i}.weight``, the transpose of flax's ``dense_{i}/kernel``."""

    def __init__(self, aabb: Tuple, channels: int = 9, internal_dims: int = 32,
                 hidden: int = 2, min_max: Optional[Tuple] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.register_buffer('lo', torch.as_tensor(np.asarray(aabb[0], np.float32), device=device))
        self.register_buffer('hi', torch.as_tensor(np.asarray(aabb[1], np.float32), device=device))
        self.channels = channels
        self.min_max = min_max
        self.encoder = HashEncoder(generator=generator, device=device)
        dims = [self.encoder.n_output_dims] + [internal_dims] * hidden + [channels]
        for i in range(hidden + 1):
            lin = nn.Linear(dims[i], dims[i + 1], bias=False, device=device)
            bound = float(np.sqrt(6.0 / dims[i]))
            with torch.no_grad():
                lin.weight.uniform_(-bound, bound, generator=generator)
            self.add_module(f'dense_{i}', lin)
        self.hidden = hidden
        if min_max is not None:
            self.register_buffer('mm_lo', torch.as_tensor(np.asarray(min_max[0], np.float32),
                                                          device=device))
            self.register_buffer('mm_hi', torch.as_tensor(np.asarray(min_max[1], np.float32),
                                                          device=device))

    def forward(self, texc: torch.Tensor) -> torch.Tensor:
        shape = texc.shape
        x = torch.clamp((texc.reshape(-1, 3) - self.lo) / (self.hi - self.lo), 0.0, 1.0)
        h = self.encoder(x)
        for i in range(self.hidden):
            h = torch.relu(getattr(self, f'dense_{i}')(h))
        out = getattr(self, f'dense_{self.hidden}')(h)
        if self.min_max is not None:
            out = torch.sigmoid(out) * (self.mm_hi - self.mm_lo) + self.mm_lo
        return out.reshape(*shape[:-1], self.channels)

    def sample(self, texc: torch.Tensor) -> torch.Tensor:
        """The texture at positions (..., 3): the Texture2D-like API a
        material's 'kd_ks_normal' entry offers."""
        return self(texc)
