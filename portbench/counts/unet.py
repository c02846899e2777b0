"""Work of one U-Net forward at a batch, from the configuration's shapes.

``forward_flops`` counts the products of every conv, Dense, NIN and
attention matmul (2 per multiply-add): the tensor-core work of the step,
the numerator of ``mfu.gen``. Elementwise work (GroupNorm, SiLU, adds,
softmax) is under 1 % of it and is not counted. The ``pos_layer`` conv is
not computed (its input is zero: only its bias is added), and the mask
conv runs on the (1, R, R, R) mask, once a forward.

``kernel_calls`` lists what the port's kernels get a forward: each
ResnetBlock's two GroupNorm -> SiLU -> conv3^3 chains go to K3
(``gn_silu_conv3d``) with x's shape and dtype, and each K3 call and the
output head's GroupNorm + SiLU run one ``gn_stats`` launch. x's dtype
follows the program's dtype flow (the JAX package's): convs return the
compute dtype (bf16), a NIN returns fp32, so a block with a NIN shortcut
and every attention block return fp32, a residual sum or concatenation
takes the wider of its inputs.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..reference.unet import layout, level_blocks

BF16, F32 = 'bfloat16', 'float32'


def _wider(a: str, b: str) -> str:
    return F32 if F32 in (a, b) else BF16


def walk(a: dict, B: int) -> Dict[str, object]:
    """{'flops': float, 'k3': [(x_shape, dtype, out_ch)], 'gn_stats':
    [(x_shape, dtype)]} of one forward at batch B."""
    nf, L, k, C = a['nf'], len(a['ch_mult']), a['k'], a['C']
    R = a['R']
    res = [R // 2 ** i for i in range(L)]
    mods = iter(layout(a))
    flops = 0.0
    k3: List[Tuple] = []
    stats: List[Tuple] = []

    def conv(n_out_vox, cin, cout, kk, batch=B):
        nonlocal flops
        flops += 2.0 * batch * n_out_vox * kk ** 3 * cin * cout

    def dense(cin, cout):
        nonlocal flops
        flops += 2.0 * B * cin * cout

    def nin(r, cin, cout):
        nonlocal flops
        flops += 2.0 * B * r ** 3 * cin * cout

    def resblock(r, dt):
        _, cin, cout = next(mods)
        k3.append(((B, r, r, r, cin), dt, cout))
        conv(r ** 3, cin, cout, 3)
        dense(4 * nf, cout)
        k3.append(((B, r, r, r, cout), BF16, cout))
        conv(r ** 3, cout, cout, 3)
        if cin != cout:
            nin(r, cin, cout)
            return F32
        return _wider(dt, BF16)

    def attn(r):
        nonlocal flops
        _, ch = next(mods)
        for _ in range(4):
            nin(r, ch, ch)
        flops += 2 * 2.0 * B * (r ** 3) ** 2 * ch
        return F32

    def resample(r_out):
        _, ch = next(mods)
        conv(r_out ** 3, ch, ch, 3)
        return BF16

    next(mods), next(mods)
    dense(nf, 4 * nf)
    dense(4 * nf, 4 * nf)
    next(mods)
    conv(R ** 3, C, nf, k)                 # stem
    conv(R ** 3, 1, nf, k, batch=1)        # mask_layer on the (1, R, R, R) mask
    hs = [BF16]
    for lev in range(L):
        for _ in range(level_blocks(a, lev)):
            dt = resblock(res[lev], hs[-1])
            if res[lev] in a['attn']:
                dt = attn(res[lev])
            hs.append(dt)
        if lev != L - 1:
            hs.append(resample(res[lev + 1]))
    dt = resblock(res[-1], hs[-1])
    dt = attn(res[-1])
    dt = resblock(res[-1], dt)
    for lev in reversed(range(L)):
        for _ in range(level_blocks(a, lev) + 1):
            dt = resblock(res[lev], _wider(dt, hs.pop()))
        if res[lev] in a['attn']:
            dt = attn(res[lev])
        if lev != 0:
            dt = resample(res[lev - 1])
    _, ch = next(mods)
    stats += [(x, d) for x, d, _ in k3]
    stats.append(((B, R, R, R, ch), dt))
    next(mods)
    conv(R ** 3, ch, C, k)                 # output conv
    return {'flops': flops, 'k3': k3, 'gn_stats': stats}
