"""(FLOP, bytes) of one call of each of the port's kernels, from shapes.

Frozen copies of the ``*_cost`` helpers of ``meshdiffusion_tpu_torch/ops``
at commit 5c79c5a (``gn_silu_conv.py::gn_silu_conv3d_cost``,
``groupnorm.py::gn_affine_cost``).
Dtypes are given by name (``'float32'``, ``'bfloat16'``).
"""

from __future__ import annotations

import math
from typing import Tuple

from .roofline import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, bound_s

ESIZE = {'float32': 4, 'bfloat16': 2, 'float16': 2}


def gn_silu_conv3d_cost(x_shape, x_dtype: str, out_ch: int) -> Tuple[float, float]:
    """K3: 2 * M * 27 * C * O over the M output voxels on the bf16 tensor
    cores; x, the bf16 weights, the bf16 output, the fp32 affine and bias
    each moved once."""
    B, D, H, W, C = x_shape
    M = B * D * H * W
    nbytes = (M * C * ESIZE[x_dtype] + 27 * C * out_ch * 2 + M * out_ch * 2
              + 2 * B * C * 4 + out_ch * 4)
    return 2.0 * M * 27 * C * out_ch, float(nbytes)


def gn_silu_conv3d_bound_s(x_shape, x_dtype: str, out_ch: int) -> float:
    return bound_s(*gn_silu_conv3d_cost(x_shape, x_dtype, out_ch), PEAK_BF16_FLOPS)[0]


def gn_affine_cost(x_shape, x_dtype: str) -> Tuple[float, float]:
    """gn_stats: 3 fp32 operations an element (a running sum and sum of
    squares); x read once, fp32 a and b written once."""
    n, B, C = math.prod(x_shape), x_shape[0], x_shape[-1]
    return 3.0 * n, float(n * ESIZE[x_dtype] + 2 * B * C * 4 + 2 * C * 4)


def gn_affine_bound_s(x_shape, x_dtype: str) -> float:
    return bound_s(*gn_affine_cost(x_shape, x_dtype), PEAK_FP32_FLOPS)[0]

