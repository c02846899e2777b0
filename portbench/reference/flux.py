"""Plain fp32 FLUX.1 MMDiT in 3D patches, written from the published
architecture: black-forest-labs/flux (``src/flux/model.py``,
``src/flux/modules/layers.py``, ``src/flux/math.py``; the widths of
``configs["flux-dev"]`` in ``src/flux/util.py``), as MeshDiffusion's
text-conditioned score network over the DMTet grid.

Parameters are a flat dict under FLUX's state_dict names (plus
``mask_embedder``); Linear weights (out, in), the mask's Conv3d (D, 1, p,
p, p). Activations are channels-last (B, R, R, R, C) at the ends, tokens
(B, T, D) between, and every operation runs in float32; the caller turns
TF32 off. ``q`` rounds the operands of every conv, Linear and attention
product (the identity for the reference; an fp8 rounding for the control).

The architecture (D the width, H heads of dh = D / H, M = 4 D):

* img tokens: Linear(p^3 C, D) over the grid's p^3 patches (each token's
  values in (i, j, k, c) order, tokens (d, h, w) row-major), plus the grid
  mask's Conv3d(1, D, p, stride p); txt tokens: Linear(4096, D) of txt;
* vec = MLP_t(E(t)) + MLP_g(E(1000 g)) + MLP_y(y), each MLP Linear, SiLU,
  Linear, with E(t) = [cos(t f), sin(t f)], f_i = exp(-ln(1e4) i / 128),
  i < 128, t the label;
* double block, each stream s of (img, txt) with its own weights: (shift1,
  scale1, gate1, shift2, scale2, gate2) = Linear(D, 6D)(SiLU(vec)); q, k, v
  = Linear(D, 3D)(LN(x_s) (1 + scale1) + shift1) as (3, H, dh); q and k
  RMS-normalised over dh (eps 1e-6) and multiplied by the stream's scales;
  per head, over the joint sequence cat(txt, img): softmax(R(q) R(k)^T
  dh^-1/2) v with R the rotation below; x_s += gate1 Linear(D, D)(its part
  of the heads' outputs); x_s += gate2 Linear(M, D)(GELU_tanh(Linear(D,
  M)(LN(x_s) (1 + scale2) + shift2)));
* single block over x = cat(txt, img): (shift, scale, gate) = Linear(D,
  3D)(SiLU(vec)); h = Linear(D, 3D + M)(LN(x) (1 + scale) + shift); q, k, v
  from h's first 3 D, normalised and rotated as above, attention per head;
  x += gate Linear(D + M, D)(cat(attention, GELU_tanh(h's last M)));
* the rotation R: a head's dh values are dh / 2 adjacent pairs (2 j, 2 j +
  1); pairs 0 .. a0/2 - 1 turn by the token's position on axis 0, the next
  a1 / 2 by axis 1, the last a2 / 2 by axis 2 (``axes_dim`` (a0, a1, a2)),
  pair j of an axis of width a by the angle pos theta^(-2 j / a): out_0 =
  cos x_0 - sin x_1, out_1 = sin x_0 + cos x_1. Image token (d, h, w) sits at
  (d, h, w), every text token at (0, 0, 0);
* out, on the img tokens: (shift, scale) = Linear(D, 2D)(SiLU(vec));
  Linear(D, p^3 C)(LN(x) (1 + scale) + shift), each token's values a patch
  in (i, j, k, c) order. LN is a LayerNorm without affine, eps 1e-6.

Departures from FLUX: 3D patches of the grid's 4 channels and 3D
positions; the mask embedding; an epsilon output (for the VP SDE) in place
of the flow's velocity, with the label t x 999 in place of 1000 t; no
intermediate roundings (FLUX rounds q and k to bf16 after the RMS, the
scale and the rotation; here all is fp32).

:func:`make_weights` draws every parameter from a seed on the device (the
same seed, the same tensors bit for bit): Linears and the mask projection
xavier-uniform, biases uniform in +-0.05, the modulations' biases uniform in
+-0.5 so that every gate, scale and shift is far from zero and the final
layer is not zero, and the RMSNorm scales uniform in [0.5, 1.5], so that a
scale left out shows."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .dit import FREQ_DIM, Quant, _ident, timestep_embedding

BIAS, MOD_BIAS, NORM_SCALE = 0.05, 0.5, 0.5
GUIDANCE_FACTOR = 1000.0


def arch(cfg: dict) -> dict:
    """The architecture's numbers from a configuration file's dict."""
    m, d = cfg['model'], cfg['data']
    return dict(R=d['image_size'], C=d['num_channels'], D=m['hidden_size'], H=m['num_heads'],
                mlp=int(m['hidden_size'] * m['mlp_ratio']), depth=m['depth'],
                single=m['depth_single_blocks'], axes=tuple(m['axes_dim']),
                theta=float(m['theta']), ctx=m['context_in_dim'], ctx_len=m['context_len'],
                vec=m['vec_in_dim'], p=m['patch_size'],
                centered=d['centered'])


def param_specs(a: dict) -> List[Tuple[str, Tuple[int, ...], str, int, int]]:
    """Every parameter as (key, shape, kind, fan_in, fan_out), kind one of
    'weight', 'bias', 'mod_bias', 'norm_scale', in the program's order."""
    D, C, p, M = a['D'], a['C'], a['p'], a['mlp']
    dh = D // a['H']
    out = []

    def linear(key, cin, cout, bias='bias'):
        out.append((key + '.weight', (cout, cin), 'weight', cin, cout))
        out.append((key + '.bias', (cout,), bias, 0, 0))

    def norm(key):
        for n in ('query_norm', 'key_norm'):
            out.append((f'{key}.{n}.scale', (dh,), 'norm_scale', 0, 0))

    linear('img_in', p ** 3 * C, D)
    out.append(('mask_embedder.proj.weight', (D, 1, p, p, p), 'weight', p ** 3, D))
    out.append(('mask_embedder.proj.bias', (D,), 'bias', 0, 0))
    linear('txt_in', a['ctx'], D)
    for key, cin in (('time_in', FREQ_DIM), ('vector_in', a['vec']), ('guidance_in', FREQ_DIM)):
        linear(key + '.in_layer', cin, D)
        linear(key + '.out_layer', D, D)
    for i in range(a['depth']):
        for s in ('img', 'txt'):
            key = f'double_blocks.{i}.{s}'
            linear(key + '_mod.lin', D, 6 * D, 'mod_bias')
            linear(key + '_attn.qkv', D, 3 * D)
            norm(key + '_attn.norm')
            linear(key + '_attn.proj', D, D)
            linear(key + '_mlp.0', D, M)
            linear(key + '_mlp.2', M, D)
    for i in range(a['single']):
        key = f'single_blocks.{i}'
        linear(key + '.linear1', D, 3 * D + M)
        linear(key + '.linear2', D + M, D)
        norm(key + '.norm')
        linear(key + '.modulation.lin', D, 3 * D, 'mod_bias')
    linear('final_layer.linear', D, p ** 3 * C)
    linear('final_layer.adaLN_modulation.1', D, 2 * D, 'mod_bias')
    return out


def make_weights(a: dict, seed: int, device) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(flat fp32 buffer, {key: view of it}) for architecture ``a``, drawn
    from ``seed`` on ``device`` in one call, then scaled a parameter at a
    time in place (no second buffer of the model's size)."""
    specs = param_specs(a)
    sizes = [math.prod(s[1]) for s in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out, o = {}, 0
    for (key, shape, kind, fi, fo), size in zip(specs, sizes):
        v = flat[o:o + size]
        if kind == 'weight':
            v.mul_(2.0).sub_(1.0).mul_(math.sqrt(6.0 / (fi + fo)))
        elif kind == 'norm_scale':
            v.mul_(2.0 * NORM_SCALE).add_(1.0 - NORM_SCALE)
        else:
            v.mul_(2.0).sub_(1.0).mul_(BIAS if kind == 'bias' else MOD_BIAS)
        out[key] = v.view(shape)
        o += size
    return flat, out


def rotation(a: dict, txt_len: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (txt_len + n^3, dh / 2) fp32: the angle of every
    pair of a head at every token of the joint sequence (module docstring),
    in float64 until the end."""
    n = a['R'] // a['p']
    u = torch.arange(n, dtype=torch.float64, device=device)
    pos = torch.stack(torch.meshgrid(u, u, u, indexing='ij'), dim=-1).reshape(-1, 3)
    pos = torch.cat([torch.zeros((txt_len, 3), dtype=torch.float64, device=device), pos])
    ang = []
    for axis, width in enumerate(a['axes']):
        j = torch.arange(width // 2, dtype=torch.float64, device=device)
        ang.append(pos[:, axis, None] * a['theta'] ** (-2.0 * j / width))
    ang = torch.cat(ang, dim=1)
    return torch.cos(ang).float(), torch.sin(ang).float()


def forward(p: Dict[str, torch.Tensor], a: dict, x: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor, txt: torch.Tensor, y: torch.Tensor, guidance: torch.Tensor,
            q: Optional[Quant] = None) -> torch.Tensor:
    """eps prediction (B, R, R, R, C) of x (B, R, R, R, C) at float timestep
    labels (B,), with the grid mask (R, R, R) and the condition: txt (B,
    T_txt, ctx), y (B, vec), guidance (B,)."""
    q = q or _ident
    D, H, ps, C = a['D'], a['H'], a['p'], a['C']
    dh = D // H
    B, R = x.shape[0], x.shape[1]
    n = R // ps
    Tt = txt.shape[1]

    def linear(key, h):
        return F.linear(q(h), q(p[key + '.weight']), p[key + '.bias'])

    def ln_mod(h, shift, scale):
        return F.layer_norm(h, (D,), eps=1e-6) * (1 + scale[:, None]) + shift[:, None]

    def embed(key, v):
        return linear(key + '.out_layer', F.silu(linear(key + '.in_layer', v)))

    cos, sin = rotation(a, Tt, x.device)

    def rotate(t):                                    # (B, L, dh)
        t0, t1 = t[..., 0::2], t[..., 1::2]
        return torch.stack([cos * t0 - sin * t1, sin * t0 + cos * t1], dim=-1).flatten(-2)

    def rms(t, key):
        return t * torch.rsqrt(t.pow(2).mean(dim=-1, keepdim=True) + 1e-6) * p[key]

    def attention(parts):
        """parts: [(qkv (B, T_s, >= 3 D), its norm's key)] in sequence
        order; the heads' outputs over the joint sequence, (B, L, D)."""
        heads = []
        for j in range(H):
            qs, ks, vs = [], [], []
            for qkv, key in parts:
                t = qkv[..., :3 * D].reshape(qkv.shape[0], qkv.shape[1], 3, H, dh)
                qs.append(rms(t[:, :, 0, j], key + '.query_norm.scale'))
                ks.append(rms(t[:, :, 1, j], key + '.key_norm.scale'))
                vs.append(t[:, :, 2, j])
            qh, kh, vh = rotate(torch.cat(qs, 1)), rotate(torch.cat(ks, 1)), torch.cat(vs, 1)
            w = torch.softmax(torch.bmm(q(qh), q(kh).transpose(1, 2)) * dh ** -0.5, dim=-1)
            heads.append(torch.bmm(q(w), q(vh)))
            del w
        return torch.cat(heads, dim=-1)

    h = x if a['centered'] else 2 * x - 1.0
    patches = h.reshape(B, n, ps, n, ps, n, ps, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
    img = linear('img_in', patches.reshape(B, n ** 3, ps ** 3 * C))
    m = F.conv3d(q(mask[None, None].float()), q(p['mask_embedder.proj.weight']),
                 p['mask_embedder.proj.bias'], stride=ps)
    img = img + m.flatten(2).transpose(1, 2)
    txt = linear('txt_in', txt)
    vec = (embed('time_in', timestep_embedding(labels)) + embed('vector_in', y)
           + embed('guidance_in', timestep_embedding(GUIDANCE_FACTOR * guidance)))
    sv = F.silu(vec)
    for i in range(a['depth']):
        key = f'double_blocks.{i}'
        im = linear(key + '.img_mod.lin', sv).chunk(6, dim=-1)
        tm = linear(key + '.txt_mod.lin', sv).chunk(6, dim=-1)
        t_qkv = linear(key + '.txt_attn.qkv', ln_mod(txt, tm[0], tm[1]))
        i_qkv = linear(key + '.img_attn.qkv', ln_mod(img, im[0], im[1]))
        att = attention([(t_qkv, key + '.txt_attn.norm'), (i_qkv, key + '.img_attn.norm')])
        del t_qkv, i_qkv
        txt = txt + tm[2][:, None] * linear(key + '.txt_attn.proj', att[:, :Tt])
        img = img + im[2][:, None] * linear(key + '.img_attn.proj', att[:, Tt:])
        del att
        for s, mod in (('img', im), ('txt', tm)):
            xs = img if s == 'img' else txt
            yv = linear(f'{key}.{s}_mlp.2', F.gelu(linear(f'{key}.{s}_mlp.0',
                                                          ln_mod(xs, mod[3], mod[4])),
                                                   approximate='tanh'))
            xs = xs + mod[5][:, None] * yv
            if s == 'img':
                img = xs
            else:
                txt = xs
    x = torch.cat([txt, img], dim=1)
    del txt, img
    for i in range(a['single']):
        key = f'single_blocks.{i}'
        shift, scale, gate = linear(key + '.modulation.lin', sv).chunk(3, dim=-1)
        hh = linear(key + '.linear1', ln_mod(x, shift, scale))
        att = attention([(hh, key + '.norm')])
        yv = linear(key + '.linear2', torch.cat([att, F.gelu(hh[..., 3 * D:], approximate='tanh')],
                                                dim=-1))
        del hh, att
        x = x + gate[:, None] * yv
    shift, scale = linear('final_layer.adaLN_modulation.1', sv).chunk(2, dim=-1)
    out = linear('final_layer.linear', ln_mod(x[:, Tt:], shift, scale))    # (B, T, p^3 C)
    out = out.reshape(B, n, n, n, ps, ps, ps, C)
    return torch.einsum('bdhwijkc->bdihjwkc', out).reshape(B, R, R, R, C)
