"""attn_roofline.dit (%): the DiT attention kernel's (``ops/dit_attention.py``,
``csrc/dit_attention.cu``) share of its roofline: the bound of each call,
max(FLOP / 989 TFLOP/s, bytes / 3.35 TB/s) with the FLOP 4 B H T^2 dh and
the bytes 8 B T D (``counts/dit.py``), summed over the window's calls (one
a block: 28 a DiT-XL forward), over their device time. Read only from a
window that recorded every call; a program without the kernel reads None."""

from portbench.counts.dit import attention_cost
from portbench.counts.roofline import PEAK_BF16_FLOPS, bound_s

NAMES = ('dit_attention_kernel',)


def read(ctx):
    calls = ctx.walk.get('attn')
    w = ctx.window
    if not calls or w.count(NAMES) != len(calls) * ctx.forwards:
        return None
    bound = ctx.forwards * sum(bound_s(*attention_cost(*c), PEAK_BF16_FLOPS)[0] for c in calls)
    return 100.0 * bound / w.device_s(NAMES)
