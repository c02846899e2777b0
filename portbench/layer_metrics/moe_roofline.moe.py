"""moe_roofline.moe (%): the grouped expert kernels' (``ops/moe_experts.py``,
``csrc/moe_experts.cu``: ``moe_gate_up_kernel`` and ``moe_down_kernel``)
share of their roofline: the bound of each mode's call, max(FLOP / 989
TFLOP/s, bytes / 3.35 TB/s) with ``counts/dit_moe.py``'s ``experts_cost``
(FLOP 2 rows D 2F and 2 rows F D, whatever the routing), summed over the
window's calls (one of each a block: 28 a DiT-MoE-XL forward), over both
kernels' device time. Read only from a window that recorded every launch
of both; a program without the kernels reads None."""

from portbench.counts.dit_moe import experts_cost
from portbench.counts.roofline import PEAK_BF16_FLOPS, bound_s

NAMES = ('moe_gate_up_kernel', 'moe_down_kernel')


def read(ctx):
    calls = ctx.walk.get('experts')
    w = ctx.window
    if not calls or any(w.count((n,)) != len(calls) * ctx.forwards for n in NAMES):
        return None
    bound = ctx.forwards * sum(bound_s(*cost, PEAK_BF16_FLOPS)[0]
                               for c in calls for cost in experts_cost(*c).values())
    return 100.0 * bound / w.device_s(NAMES)
