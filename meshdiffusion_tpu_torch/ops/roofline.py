"""The least time an H100 could take for a kernel's work (its bound).

Published peaks of one NVIDIA H100 SXM (dense, at the 700 W power limit):
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside them,
3.35 TB/s of HBM3. A kernel's bound is the larger of its bytes over the
memory rate (each input read once, each output written once) and its
operations over the peak rate of their type. Every kernel module has a
``*_cost`` helper that counts both for its wrapper's inputs.

The 67 TFLOP/s fp32 figure counts a fused multiply-add as two operations.
A kernel that must round every product and sum on its own (no FMA) issues
one fp32 instruction an operation: 132 SMs x 128 fp32 lanes x 1.98 GHz,
``PEAK_FP32_UNFUSED_OPS``; the four schedulers of an SM issue no more
than those 128 instructions a clock, of any type. Compares, minimum,
maximum and predicate logic run on the ALU pipe, 64 results a clock an SM
(the CUDA C++ Programming Guide's throughput table, compute capability
9.0): ``PEAK_ALU_OPS``.
"""

from __future__ import annotations

from typing import Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_FP32_UNFUSED_OPS = 132 * 128 * 1.98e9
PEAK_ALU_OPS = 132 * 64 * 1.98e9
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(flop: float, nbytes: float, flop_rate: float = PEAK_FP32_FLOPS) -> Tuple[float, str]:
    """(least time in ms, what sets it: ``'bytes'`` or ``'operations'``)."""
    return pipes_bound_ms(nbytes, (flop, flop_rate))


def pipes_bound_ms(nbytes: float, *pipes: Tuple[float, float]) -> Tuple[float, str]:
    """:func:`bound_ms` for operations spread over units that run side by
    side, each given as (operations, rate): the busiest sets their time."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, max(ops / rate for ops, rate in pipes)
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')
