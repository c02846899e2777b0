"""moe_share.moe (%): the share of the profiled window's device time spent
in kernels launched inside the program's ``dit.moe`` spans (each
sparse-expert block's second half: its LayerNorm and modulation, the
router, top 2, counts and permutation, both expert kernels, the shared
expert, the sums and the gated residual sum). Each kernel is tied to its
launch on the host by correlation id (the ``gen_dit`` driver keeps them as
``window.launched``); a window without them, or a program without the
spans, reads None."""

import bisect

from portbench.spans import program


def read(ctx):
    launched = getattr(ctx.window, 'launched', None)
    got = program(ctx)
    if not launched or got is None:
        return None
    moe = sorted((s.t0, s.t1) for s in got[0] if s.name == 'dit.moe')
    if not moe:
        return None
    starts = [a for a, _ in moe]
    total = inside = 0
    for _, t, dur in launched:
        i = bisect.bisect_right(starts, t) - 1
        total += dur
        inside += dur if i >= 0 and t <= moe[i][1] else 0
    return 100.0 * inside / total if total else None
