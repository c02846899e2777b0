"""idle_share.gen (%): the share of the profiled window in which no
operation ran on the card, under the sampler's Python loop
(``diffusion/sampling.py``): 1 - the union of device intervals / the
window."""


def read(ctx):
    w = ctx.window
    if not w.device:
        return None
    return 100.0 * (1.0 - w.busy_s() / w.window_s)
