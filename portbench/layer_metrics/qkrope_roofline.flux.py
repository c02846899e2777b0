"""qkrope_roofline.flux (%): the QK norm and RoPE kernel's
(``ops/qk_norm_rope.py``, ``csrc/qk_norm_rope.cu``: ``qk_norm_rope_kernel``)
share of its roofline: the bound of each call, max(FLOP / 989 TFLOP/s,
bytes / 3.35 TB/s) with ``counts/flux.py``'s ``qk_norm_rope_cost`` (each
bf16 row of 3 D read and written once, the rotation table read once:
bytes bound it), summed over the window's calls (one a block: 30 a forward
of the cut FLUX-dev), over their device time. Read only from a window that
recorded every call; a program without the kernel reads None."""

from portbench.counts.flux import qk_norm_rope_cost
from portbench.counts.roofline import PEAK_BF16_FLOPS, bound_s

NAMES = ('qk_norm_rope_kernel',)


def read(ctx):
    calls = ctx.walk.get('qkrope')
    w = ctx.window
    if not calls or w.count(NAMES) != len(calls) * ctx.forwards:
        return None
    bound = ctx.forwards * sum(bound_s(*qk_norm_rope_cost(*c), PEAK_BF16_FLOPS)[0] for c in calls)
    return 100.0 * bound / w.device_s(NAMES)
