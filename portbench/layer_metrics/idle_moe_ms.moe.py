"""idle_moe_ms.moe (ms): device-idle ms a sampler step while the innermost
open program span is the sparse-expert layer's own (``moe.route``: the
router to the permutation; ``moe.combine``: the slots' sum): the routing's
host work between launches, outside any kernel wrapper, from the port's own
spans over the profiled window (``portbench/spans.py``). A program without
the spans reads None."""

from portbench.spans import idle_ms, program


def read(ctx):
    got = program(ctx)
    if got is None or not any(s.name.startswith('moe.') for s in got[0]):
        return None
    return idle_ms(ctx, 'moe')
