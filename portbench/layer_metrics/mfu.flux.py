"""mfu.flux (%): the whole sampler step's share of the H100's bf16 peak
(989 TFLOP/s dense): the count of one FLUX forward's Linears, mask
projection and attention products (``counts/flux.py``) over the seconds a
step took by the host clock, over the traced run's window less its
profiled steps, times the peak."""

from portbench.counts.roofline import PEAK_BF16_FLOPS


def read(ctx):
    return 100.0 * ctx.walk['flops'] / (ctx.step_s * PEAK_BF16_FLOPS)
