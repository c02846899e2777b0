"""attn_roofline.flux (%): the attention kernel's dh-128 instantiation's
(``ops/dit_attention.py``, ``csrc/dit_attention.cu``:
``dit_attention_dh128_kernel``) share of its roofline in the FLUX blocks:
the bound of each call, max(FLOP / 989 TFLOP/s, bytes / 3.35 TB/s) with the
FLOP 4 B H L^2 dh and the bytes 8 B L D (``counts/dit.py``), summed over
the window's calls (one a block: 30 a forward of the cut FLUX-dev), over
their device time. Read only from a window that recorded every call; a
program without the kernel reads None."""

from portbench.counts.dit import attention_cost
from portbench.counts.roofline import PEAK_BF16_FLOPS, bound_s

NAMES = ('dit_attention_dh128_kernel',)


def read(ctx):
    calls = ctx.walk.get('attn')
    w = ctx.window
    if not calls or w.count(NAMES) != len(calls) * ctx.forwards:
        return None
    bound = ctx.forwards * sum(bound_s(*attention_cost(*c), PEAK_BF16_FLOPS)[0] for c in calls)
    return 100.0 * bound / w.device_s(NAMES)
