"""Work of one DiT forward at a batch, from the configuration's shapes.

``walk`` counts the products of every patch projection, Linear and
attention matmul (2 per multiply-add): the tensor-core work of the step,
the numerator of ``mfu.dit``. Elementwise work (LayerNorm, modulation,
GELU, softmax, gated sums) is under 1 % of it and is not counted. The mask
projection runs on the (1, R, R, R) mask, once a forward. ``attn`` lists
each block's attention call as (B, T, H, dh), and :func:`attention_cost`
gives a call's (FLOP, bytes): 4 B H T^2 dh with the real dh (not the depth
the kernel pads it to), the bf16 qkv read once and the bf16 output written
once.
"""

from __future__ import annotations

from typing import Dict, Tuple

FREQ_DIM = 256


def attention_cost(B: int, T: int, H: int, dh: int) -> Tuple[float, float]:
    return 4.0 * B * H * T * T * dh, 4.0 * B * T * H * dh * 2


def walk(a: dict, B: int) -> Dict[str, object]:
    """{'flops': float, 'attn': [(B, T, H, dh)] a block} of one forward at
    batch B."""
    D, H, p, C, M = a['D'], a['H'], a['p'], a['C'], a['mlp']
    T = (a['R'] // p) ** 3
    flops = 2.0 * B * T * p ** 3 * C * D + 2.0 * T * p ** 3 * D       # x and mask projections
    flops += 2.0 * B * (FREQ_DIM * D + D * D)                          # timestep MLP
    block = (2.0 * B * D * 6 * D                                       # adaLN modulation
             + 2.0 * B * T * D * (3 * D + D + 2 * M)                   # qkv, proj, fc1, fc2
             + attention_cost(B, T, H, D // H)[0])
    flops += a['depth'] * block
    flops += 2.0 * B * D * 2 * D + 2.0 * B * T * D * p ** 3 * C        # final layer
    return {'flops': flops, 'attn': [(B, T, H, D // H)] * a['depth']}
