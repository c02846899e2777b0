"""Work of one FLUX MMDiT forward at a batch, from the configuration's
shapes.

``walk`` counts the products of every Linear, the mask projection and the
attention matmuls (2 per multiply-add): the tensor-core work of the step,
the numerator of ``mfu.flux``. Per forward at batch B, with Ti = (R/p)^3
img tokens, Tt txt tokens, L = Tt + Ti, M = 4 D:

* img_in 2 B Ti p^3 C D, the mask's projection 2 Ti p^3 D (once), txt_in
  2 B Tt ctx D, the conditioning MLPs 2 B (256 D + D^2) each for t and the
  guidance, 2 B (vec D + D^2) for y;
* a double block: the two streams' modulations 2 x 2 B D 6D; each
  stream's qkv, proj and MLP, 2 B T_s D (3D + D + 2M); the joint attention;
* a single block: its modulation 2 B D 3D, linear1 2 B L D (3D + M),
  linear2 2 B L (D + M) D; the attention;
* the final layer 2 B D 2D + 2 B Ti D p^3 C.

Elementwise work (LayerNorm, modulation, the QK norm and rotation, GELU,
softmax, concatenations, gated sums) is left out, as in ``counts/dit.py``.
``attn`` lists each block's attention call as (B, L, H, dh), priced by
``counts/dit.py``'s ``attention_cost`` (4 B H L^2 dh, the bf16 q, k, v read
once, the output written once); ``qkrope`` each block's QK norm and RoPE
call as (B, L, H, dh), priced by :func:`qk_norm_rope_cost`, a frozen copy
of ``meshdiffusion_tpu_torch/ops/qk_norm_rope.py::qk_norm_rope_cost``.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .dit import FREQ_DIM, attention_cost


def qk_norm_rope_cost(B: int, T: int, H: int, dh: int) -> Tuple[float, float]:
    """(FLOP, bytes) of one call over T joint tokens: ~10 fp32 operations a
    q or k value; each bf16 row of 3 D read once and written once, the
    rotation table (T, dh / 2, 2) fp32 read once."""
    D = H * dh
    return 10.0 * B * T * 2 * D, 2.0 * B * T * 3 * D * 2 + T * dh * 4


def parts(a: dict, B: int) -> Dict[str, float]:
    """FLOP of one forward by part: 'img' (the img stream's Linears in the
    double blocks), 'txt' (the txt stream's), 'single' (linear1 and linear2),
    'attn' (every attention call), 'rest' (embedders, modulations, the final
    layer)."""
    D, H, p, C, M = a['D'], a['H'], a['p'], a['C'], a['mlp']
    Ti = (a['R'] // p) ** 3
    Tt = a['ctx_len']
    L = Ti + Tt
    stream = D * (3 * D + D + 2 * M)
    rest = (2.0 * B * Ti * p ** 3 * C * D + 2.0 * Ti * p ** 3 * D + 2.0 * B * Tt * a['ctx'] * D
            + 2.0 * B * (FREQ_DIM * D + D * D) * 2
            + 2.0 * B * (a['vec'] * D + D * D)
            + a['depth'] * 2 * 2.0 * B * D * 6 * D + a['single'] * 2.0 * B * D * 3 * D
            + 2.0 * B * D * 2 * D + 2.0 * B * Ti * D * p ** 3 * C)
    return {'img': a['depth'] * 2.0 * B * Ti * stream,
            'txt': a['depth'] * 2.0 * B * Tt * stream,
            'single': a['single'] * (2.0 * B * L * D * (3 * D + M) + 2.0 * B * L * (D + M) * D),
            'attn': (a['depth'] + a['single']) * attention_cost(B, L, H, D // H)[0],
            'rest': rest}


def walk(a: dict, B: int) -> Dict[str, object]:
    """{'flops': float, 'attn': [(B, L, H, dh)] a block, 'qkrope': [(B, L, H,
    dh)] a block} of one forward at batch B, double blocks first."""
    D, H = a['D'], a['H']
    L = (a['R'] // a['p']) ** 3 + a['ctx_len']
    calls = [(B, L, H, D // H)] * (a['depth'] + a['single'])
    return {'flops': sum(parts(a, B).values()), 'attn': calls, 'qkrope': list(calls)}
