"""idle_flux_ms.flux (ms): device-idle ms a sampler step while the
innermost open program span is the FLUX model's own (``flux.forward``,
``flux.cond``, ``flux.double``, ``flux.single``, ``flux.attn``,
``flux.mlp``: the model's Python between launches, outside any kernel
wrapper), from the port's own spans over the profiled window
(``portbench/spans.py``)."""

from portbench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, 'flux')
