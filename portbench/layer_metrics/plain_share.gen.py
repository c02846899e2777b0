"""plain_share.gen (%): the share of the window's device time spent in
operations other than the port's hand-written kernels (K3, gn_stats, the
GroupNorm+SiLU apply, ancestral_update, tile_zmin): the plain PyTorch work
of ``models/unet3d.py`` and ``models/layers.py`` (cuDNN's convs, NIN and
attention matmuls, casts, adds, concatenations)."""


def read(ctx):
    w = ctx.window
    total = w.device_s()
    if not total:
        return None
    return 100.0 * (total - w.own_s()) / total
