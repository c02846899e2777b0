"""idle_dit_ms.dit (ms): device-idle ms a sampler step while the innermost
open program span is the DiT's own (``dit.forward``, ``dit.block``,
``dit.attn``, ``dit.mlp``: the model's Python between launches, outside
any kernel wrapper), from the port's own spans over the profiled window
(``portbench/spans.py``)."""

from portbench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, 'dit')
