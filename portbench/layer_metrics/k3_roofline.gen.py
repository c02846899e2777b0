"""k3_roofline.gen (%): K3's (``ops/gn_silu_conv.py`` ->
``csrc/gn_silu_conv3d.cu``) share of its roofline: the frozen cost count's
bound (``counts/kernels.py``) summed over the window's K3 calls, over
their device time (the conv kernel and its split-K reduction). Read only
from a window that recorded every launch (74 a res64 forward, 64 a res128
forward)."""

from portbench.counts.kernels import gn_silu_conv3d_bound_s
from portbench.trace import OWN_KERNELS

NAMES = OWN_KERNELS['gn_silu_conv3d']


def read(ctx):
    w = ctx.window
    if w.count(NAMES) != len(ctx.walk['k3']) * ctx.forwards:
        return None
    bound = ctx.forwards * sum(gn_silu_conv3d_bound_s(x, dt, o) for x, dt, o in ctx.walk['k3'])
    return 100.0 * bound / w.device_s(NAMES)
