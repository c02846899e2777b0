"""gn_stats_roofline.gen (%): the GroupNorm statistics kernel's
(``ops/groupnorm.py`` -> ``csrc/gn_stats.cu``) share of its roofline: the
frozen cost count's bound summed over the window's calls (one a K3 call,
one for the output head: 75 a res64 forward, 65 a res128 forward), over
their device time. Read only from a window that recorded every launch."""

from portbench.counts.kernels import gn_affine_bound_s
from portbench.trace import OWN_KERNELS

NAMES = OWN_KERNELS['gn_stats']


def read(ctx):
    w = ctx.window
    if w.count(NAMES) != len(ctx.walk['gn_stats']) * ctx.forwards:
        return None
    bound = ctx.forwards * sum(gn_affine_bound_s(x, dt) for x, dt in ctx.walk['gn_stats'])
    return 100.0 * bound / w.device_s(NAMES)
