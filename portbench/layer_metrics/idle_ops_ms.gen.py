"""idle_ops_ms.gen (ms): device-idle ms a sampler step while the innermost
open program span is a kernel wrapper's (``ops.<wrapper>``: the wrappers'
checks, plans, allocations and ctypes or Triton launch calls between
kernels), from the port's own spans over the profiled window
(``portbench/spans.py``)."""

from portbench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, 'ops')
