"""idle_sampler_ms.gen (ms): device-idle ms a sampler step while the
innermost open program span is ``sampler.step`` itself (the sampler
loop's own Python, outside the U-Net and the kernel wrappers), from the
port's own spans over the profiled window (``portbench/spans.py``)."""

from portbench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, 'sampler')
