"""mfu.gen (%): the whole sampler step's share of the H100's bf16 peak
(989 TFLOP/s dense): the frozen count of one U-Net forward's conv, Dense,
NIN and attention products (``counts/unet.py``) over the seconds a step
took by the host clock, over the traced run's window less its profiled
steps (the profiler's runtime tracing slows a host-bound step), times the
peak."""

from portbench.counts.roofline import PEAK_BF16_FLOPS


def read(ctx):
    return 100.0 * ctx.walk['flops'] / (ctx.step_s * PEAK_BF16_FLOPS)
