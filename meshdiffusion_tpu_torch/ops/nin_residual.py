"""A ResnetBlock's NIN shortcut and its residual sum in one pass.

    out[m, n] = (sum_k bf16(x[m, k]) * W[k, n], in fp32) + b[n] + float(h[m, n])

over the voxels m of a channels-last x (B, D, H, W, K): the 1x1 shortcut of
a block whose width changes (``models/layers.py``, ``NIN_0``) and the sum
``x + h`` that ends the block. No TPU kernel corresponds: the JAX package
computes the shortcut as a plain ``jnp.dot(x.astype(bf16), W.astype(bf16),
preferred_element_type=float32) + b`` and the residual sum after it
(``meshdiffusion_tpu/models/layers.py:65-67`` and ``:275-276``), which XLA
fuses on the TPU. The plain version here does the same in four passes
around an fp32 matrix product of the operands' bf16 values.

What bounds it on the H100: memory. K is 128 to 1024 and N 128 to 512, so a
voxel's row costs at most ~60 operations a byte against the card's ~295 at
its ridge. The kernel reads x at its own dtype once (an fp32 value is
rounded to bf16, to nearest even, as it is loaded), reads the bf16 h once,
writes the fp32 output once, and reads W (at most 1 MiB of bf16) from L2
after the first blocks.

Design (CUDA C++, sm_90a, ``csrc/nin_residual.cu``): one warpgroup a tile
of 64 voxels by 128 output channels (a wider output: its N tiles of a row
tile side by side, so x comes from L2 after the first); a 3-stage cp.async
ring over K in 64-deep chunks feeds wgmma (A, x rounded to bf16, from
registers; B, W in its own N-major layout, from shared memory; fp32 sums);
h is prefetched into L2 before the loop, the bias and then h are added
from registers and the tile is stored. No split-K: every sum is the tile's
own, so reruns agree bit for bit. The products of two bf16 values are
exact in fp32, so the result differs from the plain version only in the
order of the sum over k.

The wrapper takes its route by the rule of ``ops/_build.py`` and declares
no backward. Its plain version, :func:`nin_residual_reference`, is bit for
bit the composition ``NIN(x) + h``. The kernel runs once a call; the
wrapper counts its launches in ``nin_residual.launches``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build
from ._build import kernel_wrapper


def nin_reference(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The NIN's plain product (``models/layers.py``, ``NIN``): fp32 sums
    of ``dtype``'s values of x and W, plus b; an fp32 result (JAX:
    ``preferred_element_type=float32``)."""
    return torch.matmul(x.to(dtype).float(), W.to(dtype).float()) + b


def nin_residual_reference(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                           h: torch.Tensor, dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """Plain version: the NIN's product (:func:`nin_reference`), then plus
    h (an fp32 result)."""
    return nin_reference(x, W, b, dtype) + h


def nin_residual_cost(x_shape, x_dtype: torch.dtype, N: int) -> Tuple[float, float]:
    """(FLOP, bytes) of one call: 2 * M * K * N products on the bf16 tensor
    cores; x read once at its dtype, the bf16 W, the fp32 bias and the bf16
    h read once, the fp32 output written once."""
    K = x_shape[-1]
    M = math.prod(x_shape[:-1])
    esize = torch.empty((), dtype=x_dtype).element_size()
    return 2.0 * M * K * N, float(M * K * esize + K * N * 2 + N * 4 + M * N * 2 + M * N * 4)


@kernel_wrapper(nin_residual_reference)
def nin_residual(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``NIN(x) + h`` with the NIN's weight ``W`` (K, N) and bias ``b`` (N,):
    x (..., K) fp32 or bf16, h (..., N); returns fp32 (..., N). On CUDA
    tensors the operands are bf16 (``dtype``), W a contiguous bf16 (K, N),
    b fp32 and h bf16, all contiguous."""
    K, N = x.shape[-1], W.shape[-1]
    if W.shape != (K, N) or b.shape != (N,) or h.shape != x.shape[:-1] + (N,):
        raise ValueError(f'nin_residual: x {tuple(x.shape)}, W {tuple(W.shape)}, '
                         f'b {tuple(b.shape)} and h {tuple(h.shape)} do not agree')
    if dtype != torch.bfloat16 or W.dtype != torch.bfloat16 or b.dtype != torch.float32 \
            or h.dtype != torch.bfloat16 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError('nin_residual: takes fp32 or bf16 x, bf16 W and h, fp32 b, '
                         'and bf16 operands')
    if not all(t.is_contiguous() for t in (x, W, b, h)):
        raise ValueError('nin_residual: takes contiguous tensors')
    if K % 64 or N % 128:
        raise ValueError(f'nin_residual: K {K} must be a multiple of 64 and N {N} of 128')
    if any(t.data_ptr() % 16 for t in (x, W, b, h)):
        raise ValueError('nin_residual: takes 16-byte aligned tensors')
    out = torch.empty(h.shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib().nin_residual_bf16(
            x.data_ptr(), int(x.dtype == torch.bfloat16), W.data_ptr(), b.data_ptr(),
            h.data_ptr(), out.data_ptr(), x.numel() // K, K, N,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, 'nin_residual')
    nin_residual.launches += 1
    return out
