"""The least time an H100 could take for a kernel's work (its bound).

Frozen copy of ``meshdiffusion_tpu_torch/ops/roofline.py`` at commit
5c79c5a. Published peaks of one NVIDIA H100 SXM (dense, at the 700 W power
limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside
them, 3.35 TB/s of HBM3. A kernel's bound is the larger of its bytes over
the memory rate (each input read once, each output written once) and its
operations over the peak rate of their type.
"""

from __future__ import annotations

from typing import Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flop: float, nbytes: float, flop_rate: float = PEAK_FP32_FLOPS) -> Tuple[float, str]:
    """(least time in s, what sets it: ``'bytes'`` or ``'operations'``)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flop / flop_rate
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')
