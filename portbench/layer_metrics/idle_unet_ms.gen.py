"""idle_unet_ms.gen (ms): device-idle ms a sampler step while the innermost
open program span is the U-Net's own (``unet.forward``, ``unet.resblock``,
``unet.attn``: the model's Python between kernels, outside any kernel
wrapper), from the port's own spans over the profiled window
(``portbench/spans.py``)."""

from portbench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, 'unet')
