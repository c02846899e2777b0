"""Fused DDPM ancestral update: the elementwise tail of every sampler step.

Replaces the TPU kernel ``meshdiffusion_tpu/ops/sampler_step.py``
(``ancestral_update``, pallas_call at :75):

    score  = -eps_hat / std
    x_mean = (x + beta * score) * rsqrt(1 - beta) * mask
    x      = (x_mean + sqrt(beta) * noise) * mask

What bounds it on the H100: memory. Four tensors are read and two written
(24 MB a step at res64, batch 1), with a few flops per element.

Design: one Triton pass over the flat channels-last tensor; the grid mask
(1 or B, R, R, R, 1) is broadcast by index arithmetic, so it is never
expanded in memory. Triton's masked block loads express this fully, so it
serves as well as CUDA. The noise is an input tensor, so that the sampler
can replay another generator's noise; ``beta`` and ``std`` are fp32
scalars, and ``rsqrt(1 - beta)`` is computed in fp32 as the Pallas kernel
does (the JAX sampler's inline jnp uses a float64-built
``1/sqrt(1-beta)`` table instead: the two differ by about one fp32 ulp).

The wrapper takes its route by the rule of ``ops/_build.py`` and declares
no backward; its plain version is :func:`ancestral_update_reference`. It
counts its launches in ``ancestral_update.launches``.
"""

from __future__ import annotations  # kernel annotations stay strings until Triton reads them

import functools
import math
from typing import Tuple

import torch

from ._build import kernel_wrapper, watch_triton_compiles

# Bound at the first launch by _kernel(); see ops/groupnorm.py.
triton = tl = None


def ancestral_update_reference(x: torch.Tensor, eps_hat: torch.Tensor,
                               mask: torch.Tensor, noise: torch.Tensor,
                               beta: float, std: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version (the JAX oracle ``ancestral_update_reference``): x,
    eps_hat, noise (B, ...); mask broadcastable; beta, std fp32 scalars."""
    beta = torch.as_tensor(beta, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    score = -eps_hat / std
    x_mean = (x + beta * score) / torch.sqrt(1.0 - beta) * mask
    x_new = (x_mean + torch.sqrt(beta) * noise) * mask
    return x_new, x_mean


def ancestral_update_cost(x_shape, mask_shape) -> Tuple[float, float]:
    """(FLOP, bytes) of one call: 8 fp32 operations an element; x, eps_hat,
    noise and the mask read once, x and x_mean written once (fp32)."""
    n, nm = math.prod(x_shape), math.prod(mask_shape)
    return 8.0 * n, 4.0 * (5 * n + nm)


# Flat channels-last tensors of N elements, C channels, S voxels per sample;
# the mask has one value per voxel and batch stride mask_bs (0: shared).
def _ancestral_kernel(x_ptr, eps_ptr, mask_ptr, noise_ptr, x_out_ptr, mean_out_ptr,
                      N, C, S, mask_bs, beta, std, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < N
    row = offs // C
    mk = tl.load(mask_ptr + (row // S) * mask_bs + row % S, mask=m, other=0.0)
    x = tl.load(x_ptr + offs, mask=m, other=0.0)
    e = tl.load(eps_ptr + offs, mask=m, other=0.0)
    nz = tl.load(noise_ptr + offs, mask=m, other=0.0)
    x_mean = (x + beta * (-e / std)) * tl.rsqrt(1.0 - beta) * mk
    tl.store(mean_out_ptr + offs, x_mean, mask=m)
    tl.store(x_out_ptr + offs, (x_mean + tl.sqrt(beta) * nz) * mk, mask=m)


@functools.cache
def _kernel():
    global triton, tl
    import triton
    import triton.language as tl
    watch_triton_compiles()
    return triton.jit(_ancestral_kernel)


@kernel_wrapper(ancestral_update_reference)
def ancestral_update(x: torch.Tensor, eps_hat: torch.Tensor, mask: torch.Tensor,
                     noise: torch.Tensor, beta: float, std: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ancestral step; returns (x, x_mean). x, eps_hat, noise:
    (B, R, R, R, C) fp32; mask (1 or B, R, R, R, 1) fp32."""
    B, C = x.shape[0], x.shape[-1]
    S = x.numel() // (B * C)
    if eps_hat.shape != x.shape or noise.shape != x.shape:
        raise ValueError('x, eps_hat and noise must have one shape')
    if mask.shape[0] not in (1, B) or mask.shape[-1] != 1 or mask.numel() * C != \
            x.numel() // B * mask.shape[0]:
        raise ValueError(f'mask {tuple(mask.shape)} does not broadcast as (1|B, ..., 1) '
                         f'against x {tuple(x.shape)}')
    tensors = (x, eps_hat, mask, noise)
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in tensors):
        raise ValueError('ancestral_update takes contiguous float32 tensors')
    x_new, x_mean = torch.empty_like(x), torch.empty_like(x)
    N = x.numel()
    BLOCK = 1024
    k = _kernel()
    with torch.cuda.device(x.device):
        k[(triton.cdiv(N, BLOCK),)](x, eps_hat, mask, noise, x_new, x_mean, N, C, S,
                                    S if mask.shape[0] == B and B > 1 else 0,
                                    float(beta), float(std), BLOCK=BLOCK, num_warps=4)
    ancestral_update.launches += 1
    return x_new, x_mean
