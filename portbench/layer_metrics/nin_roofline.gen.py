"""nin_roofline.gen (%): the NIN shortcut + residual kernel's
(``ops/nin_residual.py``, ``csrc/nin_residual.cu``) share of its roofline:
the bound of each call, max(bytes / 3.35 TB/s, FLOP / 989 TFLOP/s), summed
over the window's calls (each shortcut block's, the walk's K3 calls whose input
width differs from their output width: 22 a res64 forward, 20 a res128
forward), over their device time. Read only from a window that recorded
every launch; a program without the kernel reads None."""

import math

from portbench.counts.kernels import ESIZE
from portbench.counts.roofline import PEAK_BF16_FLOPS, bound_s

NAMES = ('nin_residual',)


def cost(x_shape, x_dtype: str, N: int):
    """(FLOP, bytes) of one call: 2 M K N products; x read once at its
    dtype, the bf16 weight, the fp32 bias and the bf16 h read once, the fp32
    output written once."""
    K, M = x_shape[-1], math.prod(x_shape[:-1])
    return 2.0 * M * K * N, float(M * K * ESIZE[x_dtype] + K * N * 2 + N * 4 + M * N * 6)


def read(ctx):
    calls = [(x, dt, o) for x, dt, o in ctx.walk['k3'] if x[-1] != o]
    w = ctx.window
    if not calls or w.count(NAMES) != len(calls) * ctx.forwards:
        return None
    bound = ctx.forwards * sum(bound_s(*cost(x, dt, o), PEAK_BF16_FLOPS)[0] for x, dt, o in calls)
    return 100.0 * bound / w.device_s(NAMES)
