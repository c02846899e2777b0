"""The U-Net's weights, made on the device from the seed in a few large
calls, in the reference torch layout (the released ``.pth`` keys).

Every weight is drawn uniform at the DDPM initializer's fan-average
variance scaling with its layer's scale, except that the layers that
initializer zeroes (each block's second conv, attention's output NIN, the
output conv) take scale 1, as a trained network's are not zero (zeros
would leave those branches and the output out of every comparison).
Biases are uniform in +-0.05, GroupNorm scales 1 +- 0.1 and shifts +-0.1.
The same seed gives the same tensors, bit for bit, so the program and the
reference take the same weights."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .reference.unet import param_specs

BIAS, NORM = 0.05, 0.1


def make(a: dict, seed: int, device) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(flat fp32 buffer, {key: view of it}) for architecture ``a``."""
    specs = param_specs(a)
    sizes = [math.prod(s[1]) for s in specs]
    bounds, offsets = [], []
    for _, _, kind, fan_in, fan_out, scale in specs:
        if kind == 'weight':
            bounds.append(math.sqrt(3.0 * (scale or 1.0) / ((fan_in + fan_out) / 2.0)))
        else:
            bounds.append(BIAS if kind == 'bias' else NORM)
        offsets.append(1.0 if kind == 'norm_scale' else 0.0)
    n = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(n, generator=gen, device=device)
    reps = torch.tensor(sizes, device=device)
    bound = torch.repeat_interleave(torch.tensor(bounds, device=device), reps, output_size=n)
    offset = torch.repeat_interleave(torch.tensor(offsets, device=device), reps, output_size=n)
    flat = flat.mul_(2.0).sub_(1.0).mul_(bound).add_(offset)
    del bound, offset
    out, o = {}, 0
    for (key, shape, *_), size in zip(specs, sizes):
        out[key] = flat[o:o + size].view(shape)
        o += size
    return flat, out
