"""Plain fp32 3D U-Net of MeshDiffusion (DDPM ``ddpm_res64`` /
``ddpm_res128``), written from the published architecture.

Parameters are a flat dict in the reference torch layout (the released
``.pth`` keys): ``all_modules.{i}...`` in construction order, plus
``pos_layer`` (res64) and ``mask_layer``; Conv3d weights (O, I, k, k, k),
Linear (out, in), NIN ``W`` (in, out). Activations are channel-first
(B, C, D, H, W) and every operation runs in float32; the caller turns TF32
off. ``q`` rounds the operands of every conv, matmul and attention product
(the identity for the reference; an fp8 rounding for the control).

The architecture (ddpm_res64.py / ddpm_res128.py of MeshDiffusion): a
sinusoidal timestep embedding through two Dense layers; a k^3 stem conv
(k 3 at res64, 5 at res128) plus, at res64, the bias of ``pos_layer``
(its coordinate input is zero) and the ``mask_layer`` conv of the grid
mask; per level ResnetBlocks (GroupNorm(32) -> SiLU -> conv3^3, + Dense of
SiLU(temb), GroupNorm -> SiLU -> conv3^3, NIN shortcut where the width
changes), self-attention at the listed resolutions, a stride-2 conv after
a right pad of 1 to go down; a middle block, attention, block; the up path
concatenating the skips, nearest x2 and a conv3^3 to go up; GroupNorm ->
SiLU -> k^3 conv out. res128 has ``num_res_blocks_first`` blocks at level 0.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Quant = Callable[[torch.Tensor], torch.Tensor]


def _ident(t: torch.Tensor) -> torch.Tensor:
    return t


def arch(cfg: dict) -> dict:
    """The architecture's numbers from a configuration file's dict."""
    m, d = cfg['model'], cfg['data']
    is128 = 'res128' in m['name']
    return dict(R=d['image_size'], C=d['num_channels'], nf=m['nf'],
                ch_mult=tuple(m['ch_mult']), nrb=m['num_res_blocks'],
                nrb_first=m['num_res_blocks_first'] if is128 else None,
                attn=tuple(m['attn_resolutions']), k=5 if is128 else 3,
                coords=not is128, centered=d['centered'])


def level_blocks(a: dict, lev: int) -> int:
    return a['nrb_first'] if (lev == 0 and a['nrb_first'] is not None) else a['nrb']


def layout(a: dict) -> List[Tuple]:
    """The module list in construction order: ('dense', in, out),
    ('conv', in, out, k, stride), ('res', in, out), ('attn', ch),
    ('down', ch), ('up', ch), ('gn', ch)."""
    nf, L = a['nf'], len(a['ch_mult'])
    res = [a['R'] // 2 ** i for i in range(L)]
    mods: List[Tuple] = [('dense', nf, 4 * nf), ('dense', 4 * nf, 4 * nf),
                         ('conv', a['C'], nf, a['k'], 1)]
    hs, cin = [nf], nf
    for lev in range(L):
        for _ in range(level_blocks(a, lev)):
            cout = nf * a['ch_mult'][lev]
            mods.append(('res', cin, cout))
            cin = cout
            if res[lev] in a['attn']:
                mods.append(('attn', cin))
            hs.append(cin)
        if lev != L - 1:
            mods.append(('down', cin))
            hs.append(cin)
    mods += [('res', cin, cin), ('attn', cin), ('res', cin, cin)]
    for lev in reversed(range(L)):
        for _ in range(level_blocks(a, lev) + 1):
            cout = nf * a['ch_mult'][lev]
            mods.append(('res', cin + hs.pop(), cout))
            cin = cout
        if res[lev] in a['attn']:
            mods.append(('attn', cin))
        if lev != 0:
            mods.append(('up', cin))
    mods += [('gn', cin), ('conv', cin, a['C'], a['k'], 1)]
    return mods


def param_specs(a: dict) -> List[Tuple[str, Tuple[int, ...], str, int, int, float]]:
    """Every parameter as (key, shape, kind, fan_in, fan_out, init_scale),
    kind one of 'weight', 'bias', 'norm_scale', 'norm_bias'; init_scale is
    the DDPM initializer's variance-scaling scale of the layer (0 for the
    layers it zeroes)."""
    out = []

    def conv(key, cin, cout, k, scale=1.0):
        rf = k ** 3
        out.append((key + '.weight', (cout, cin, k, k, k), 'weight', cin * rf, cout * rf, scale))
        out.append((key + '.bias', (cout,), 'bias', 0, 0, 0.0))

    def dense(key, cin, cout):
        out.append((key + '.weight', (cout, cin), 'weight', cin, cout, 1.0))
        out.append((key + '.bias', (cout,), 'bias', 0, 0, 0.0))

    def nin(key, cin, cout, scale=0.1):
        out.append((key + '.W', (cin, cout), 'weight', cin, cout, scale))
        out.append((key + '.b', (cout,), 'bias', 0, 0, 0.0))

    def gn(key, ch):
        out.append((key + '.weight', (ch,), 'norm_scale', 0, 0, 0.0))
        out.append((key + '.bias', (ch,), 'norm_bias', 0, 0, 0.0))

    nf, k = a['nf'], a['k']
    if a['coords']:
        conv('pos_layer', 3, nf, k)
    conv('mask_layer', 1, nf, k)
    mods = layout(a)
    for i, mod in enumerate(mods):
        key = f'all_modules.{i}'
        kind = mod[0]
        if kind == 'dense':
            dense(key, mod[1], mod[2])
        elif kind == 'conv':
            conv(key, mod[1], mod[2], mod[3], 0.0 if i == len(mods) - 1 else 1.0)
        elif kind == 'res':
            cin, cout = mod[1], mod[2]
            gn(key + '.GroupNorm_0', cin)
            conv(key + '.Conv_0', cin, cout, 3)
            dense(key + '.Dense_0', 4 * nf, cout)
            gn(key + '.GroupNorm_1', cout)
            conv(key + '.Conv_1', cout, cout, 3, 0.0)
            if cin != cout:
                nin(key + '.NIN_0', cin, cout)
        elif kind == 'attn':
            gn(key + '.GroupNorm_0', mod[1])
            for j in range(4):
                nin(key + f'.NIN_{j}', mod[1], mod[1], 0.0 if j == 3 else 0.1)
        elif kind in ('down', 'up'):
            conv(key + '.Conv_0', mod[1], mod[1], 3)
        elif kind == 'gn':
            gn(key, mod[1])
    return out


def timestep_embedding(labels: torch.Tensor, dim: int, max_positions: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding of float labels (DDPM's get_timestep_embedding)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=labels.device)
                      * -(math.log(max_positions) / (half - 1)))
    emb = labels.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)


def forward(p: Dict[str, torch.Tensor], a: dict, x: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor, q: Optional[Quant] = None) -> torch.Tensor:
    """eps prediction (B, C, R, R, R) of x (B, C, R, R, R) at float timestep
    labels (B,), with the grid mask (R, R, R)."""
    q = q or _ident
    nf, L = a['nf'], len(a['ch_mult'])
    res = [a['R'] // 2 ** i for i in range(L)]
    mods = iter(enumerate(layout(a)))

    def conv(key, h, stride=1, pad=None):
        w = p[key + '.weight']
        pad = w.shape[-1] // 2 if pad is None else pad
        return F.conv3d(q(h), q(w), p[key + '.bias'], stride, pad)

    def dense(key, h):
        return F.linear(q(h), q(p[key + '.weight']), p[key + '.bias'])

    def nin(key, h):
        y = torch.einsum('bcdhw,co->bodhw', q(h), q(p[key + '.W']))
        return y + p[key + '.b'][None, :, None, None, None]

    def gn(key, h):
        return F.group_norm(h, 32, p[key + '.weight'], p[key + '.bias'], eps=1e-6)

    def resblock(h, temb):
        i, (_, cin, cout) = next(mods)
        key = f'all_modules.{i}'
        y = conv(key + '.Conv_0', F.silu(gn(key + '.GroupNorm_0', h)))
        y = y + dense(key + '.Dense_0', F.silu(temb))[:, :, None, None, None]
        y = conv(key + '.Conv_1', F.silu(gn(key + '.GroupNorm_1', y)))
        if cin != cout:
            h = nin(key + '.NIN_0', h)
        return h + y

    def attn(h):
        i, (_, ch) = next(mods)
        key = f'all_modules.{i}'
        B = h.shape[0]
        g = gn(key + '.GroupNorm_0', h)
        qq, kk, vv = (nin(key + f'.NIN_{j}', g).reshape(B, ch, -1) for j in range(3))
        w = torch.bmm(q(qq.transpose(1, 2)), q(kk)) * ch ** -0.5
        w = torch.softmax(w, dim=-1)
        y = torch.bmm(q(vv), q(w.transpose(1, 2))).reshape(h.shape)
        return h + nin(key + '.NIN_3', y)

    def down(h):
        i, _ = next(mods)
        return conv(f'all_modules.{i}.Conv_0', F.pad(h, (0, 1, 0, 1, 0, 1)), 2, 0)

    def up(h):
        i, _ = next(mods)
        return conv(f'all_modules.{i}.Conv_0', F.interpolate(h, scale_factor=2, mode='nearest'))

    temb = timestep_embedding(labels, nf)
    i, _ = next(mods)
    temb = dense(f'all_modules.{i}', temb)
    i, _ = next(mods)
    temb = dense(f'all_modules.{i}', F.silu(temb))
    h = x if a['centered'] else 2 * x - 1.0
    i, _ = next(mods)
    h = conv(f'all_modules.{i}', h)
    if a['coords']:
        h = h + p['pos_layer.bias'][None, :, None, None, None]
    h = h + conv('mask_layer', mask[None, None].float())

    hs = [h]
    for lev in range(L):
        for _ in range(level_blocks(a, lev)):
            h = resblock(hs[-1], temb)
            if res[lev] in a['attn']:
                h = attn(h)
            hs.append(h)
        if lev != L - 1:
            hs.append(down(hs[-1]))
    h = resblock(hs[-1], temb)
    h = attn(h)
    h = resblock(h, temb)
    for lev in reversed(range(L)):
        for _ in range(level_blocks(a, lev) + 1):
            h = resblock(torch.cat([h, hs.pop()], dim=1), temb)
        if res[lev] in a['attn']:
            h = attn(h)
        if lev != 0:
            h = up(h)
    i, _ = next(mods)
    h = F.silu(gn(f'all_modules.{i}', h))
    i, _ = next(mods)
    return conv(f'all_modules.{i}', h)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one per-tensor scale (amax to 448), as
    an fp8 GEMM's operands are; back in float32."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    s = amax / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s
