"""Plain fp32 3D diffusion transformer (DiT-XL/4 in 3D patches), written
from the published architecture: DiT (Peebles & Xie, arXiv:2212.09748;
``DiT_XL_4`` of facebookresearch/DiT's ``models.py``) with DiT-3D's 3D
patches and positions (Mo et al., arXiv:2307.01831), as MeshDiffusion's
score network over the DMTet grid.

Parameters are a flat dict under DiT's state_dict names (plus
``mask_embedder``); Conv3d weights (D, I, p, p, p), Linear (out, in).
Activations are channels-last (B, R, R, R, C) at the ends, tokens (B, T, D)
between, and every operation runs in float32; the caller turns TF32 off.
``q`` rounds the operands of every conv, Linear and attention product (the
identity for the reference; an fp8 rounding for the control).

The architecture:

* tokens: Conv3d(C, D, p, stride p) of x, plus Conv3d(1, D, p, stride p) of
  the grid mask (every sample's), plus the fixed positions: for token
  (d, h, w) in row-major order [E(d), E(h), E(w)], E(u) = [sin(u w_k),
  cos(u w_k)], w_k = 10000^(-k / (D/6)), k < D/6;
* c = Linear(D, D)(SiLU(Linear(256, D)([cos(t f), sin(t f)]))), f_i =
  exp(-ln(1e4) i / 128), t the label;
* each block: (shift1, scale1, gate1, shift2, scale2, gate2) =
  Linear(D, 6D)(SiLU(c)); x += gate1 proj(MHA(qkv(LN(x) (1 + scale1) +
  shift1))); x += gate2 fc2(GELU_tanh(fc1(LN(x) (1 + scale2) + shift2))),
  LN without affine, eps 1e-6; MHA per head h: softmax(q_h k_h^T dh^-1/2)
  v_h, the heads' q, k, v at (3, H, dh) of qkv's output;
* out: (shift, scale) = Linear(D, 2D)(SiLU(c)); Linear(D, p^3 C)(LN(x)
  (1 + scale) + shift), each token's p^3 C values a patch in (i, j, k, c)
  order.

Departures from DiT: no class embedder, epsilon only (``learn_sigma``
off), the mask embedding, 3D patches and positions.

:func:`make_weights` draws every parameter from a seed on the device (the
same seed, the same tensors bit for bit): Linears and patch projections
xavier-uniform, biases uniform in +-0.05, and the adaLN modulations' biases
uniform in +-0.5, so that every gate, scale and shift is far from zero and
the final layer is not zero (DiT's own initialisation zeroes them, which
would leave every block and the output out of any comparison)."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Quant = Callable[[torch.Tensor], torch.Tensor]

FREQ_DIM = 256
BIAS, MOD_BIAS = 0.05, 0.5


def _ident(t: torch.Tensor) -> torch.Tensor:
    return t


def arch(cfg: dict) -> dict:
    """The architecture's numbers from a configuration file's dict."""
    m, d = cfg['model'], cfg['data']
    return dict(R=d['image_size'], C=d['num_channels'], D=m['hidden_size'], depth=m['depth'],
                H=m['num_heads'], mlp=int(m['hidden_size'] * m['mlp_ratio']),
                p=m['patch_size'], centered=d['centered'])


def param_specs(a: dict) -> List[Tuple[str, Tuple[int, ...], str, int, int]]:
    """Every parameter as (key, shape, kind, fan_in, fan_out), kind one of
    'weight', 'bias', 'mod_bias'."""
    D, C, p, M = a['D'], a['C'], a['p'], a['mlp']
    out = []

    def linear(key, cin, cout, bias='bias'):
        out.append((key + '.weight', (cout, cin), 'weight', cin, cout))
        out.append((key + '.bias', (cout,), bias, 0, 0))

    def patch(key, cin):
        out.append((key + '.weight', (D, cin, p, p, p), 'weight', cin * p ** 3, D))
        out.append((key + '.bias', (D,), 'bias', 0, 0))

    patch('x_embedder.proj', C)
    patch('mask_embedder.proj', 1)
    linear('t_embedder.mlp.0', FREQ_DIM, D)
    linear('t_embedder.mlp.2', D, D)
    for i in range(a['depth']):
        key = f'blocks.{i}'
        linear(key + '.attn.qkv', D, 3 * D)
        linear(key + '.attn.proj', D, D)
        linear(key + '.mlp.fc1', D, M)
        linear(key + '.mlp.fc2', M, D)
        linear(key + '.adaLN_modulation.1', D, 6 * D, 'mod_bias')
    linear('final_layer.linear', D, p ** 3 * C)
    linear('final_layer.adaLN_modulation.1', D, 2 * D, 'mod_bias')
    return out


def make_weights(a: dict, seed: int, device) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(flat fp32 buffer, {key: view of it}) for architecture ``a``, drawn
    from ``seed`` on ``device`` in a few large calls."""
    specs = param_specs(a)
    sizes = [math.prod(s[1]) for s in specs]
    bounds = [math.sqrt(6.0 / (fi + fo)) if kind == 'weight'
              else (BIAS if kind == 'bias' else MOD_BIAS) for _, _, kind, fi, fo in specs]
    n = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(n, generator=gen, device=device)
    bound = torch.repeat_interleave(torch.tensor(bounds, device=device),
                                    torch.tensor(sizes, device=device), output_size=n)
    flat = flat.mul_(2.0).sub_(1.0).mul_(bound)
    del bound
    out, o = {}, 0
    for (key, shape, *_), size in zip(specs, sizes):
        out[key] = flat[o:o + size].view(shape)
        o += size
    return flat, out


def timestep_embedding(t: torch.Tensor, dim: int = FREQ_DIM) -> torch.Tensor:
    half = dim // 2
    f = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                    device=t.device) / half)
    args = t.float()[:, None] * f[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def pos_embed(D: int, n: int, device) -> torch.Tensor:
    """(n^3, D) fixed positions, token (d, h, w) at row (d n + h) n + w."""
    k = D // 6
    w = 10000.0 ** (-torch.arange(k, dtype=torch.float64, device=device) / k)
    u = torch.arange(n, dtype=torch.float64, device=device)[:, None] * w[None]
    e = torch.cat([torch.sin(u), torch.cos(u)], dim=1)             # (n, D / 3)
    ed = e[:, None, None, :].expand(n, n, n, -1)
    eh = e[None, :, None, :].expand(n, n, n, -1)
    ew = e[None, None, :, :].expand(n, n, n, -1)
    return torch.cat([ed, eh, ew], dim=-1).reshape(n ** 3, D).float()


def forward(p: Dict[str, torch.Tensor], a: dict, x: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor, q: Optional[Quant] = None) -> torch.Tensor:
    """eps prediction (B, R, R, R, C) of x (B, R, R, R, C) at float timestep
    labels (B,), with the grid mask (R, R, R)."""
    q = q or _ident
    D, H, ps, C = a['D'], a['H'], a['p'], a['C']
    dh = D // H
    B, R = x.shape[0], x.shape[1]
    n = R // ps

    def linear(key, h):
        return F.linear(q(h), q(p[key + '.weight']), p[key + '.bias'])

    def patch(key, vol):                              # (B, I, R, R, R) -> (B, T, D)
        y = F.conv3d(q(vol), q(p[key + '.weight']), p[key + '.bias'], stride=ps)
        return y.flatten(2).transpose(1, 2)

    def ln_mod(h, shift, scale):
        return F.layer_norm(h, (D,), eps=1e-6) * (1 + scale[:, None]) + shift[:, None]

    h = x if a['centered'] else 2 * x - 1.0
    tok = patch('x_embedder.proj', h.permute(0, 4, 1, 2, 3))
    tok = tok + patch('mask_embedder.proj', mask[None, None].float())
    tok = tok + pos_embed(D, n, x.device)[None]
    c = linear('t_embedder.mlp.2', F.silu(linear('t_embedder.mlp.0', timestep_embedding(labels))))
    sc = F.silu(c)
    for i in range(a['depth']):
        key = f'blocks.{i}'
        shift1, scale1, gate1, shift2, scale2, gate2 = \
            linear(key + '.adaLN_modulation.1', sc).chunk(6, dim=-1)
        qkv = linear(key + '.attn.qkv', ln_mod(tok, shift1, scale1)).reshape(B, -1, 3, H, dh)
        heads = []
        for j in range(H):
            qh, kh, vh = qkv[:, :, 0, j], qkv[:, :, 1, j], qkv[:, :, 2, j]
            w = torch.softmax(torch.bmm(q(qh), q(kh).transpose(1, 2)) * dh ** -0.5, dim=-1)
            heads.append(torch.bmm(q(w), q(vh)))
            del w
        y = linear(key + '.attn.proj', torch.cat(heads, dim=-1))
        del heads, qkv
        tok = tok + gate1[:, None] * y
        y = linear(key + '.mlp.fc1', ln_mod(tok, shift2, scale2))
        y = linear(key + '.mlp.fc2', F.gelu(y, approximate='tanh'))
        tok = tok + gate2[:, None] * y
        del y
    shift, scale = linear('final_layer.adaLN_modulation.1', sc).chunk(2, dim=-1)
    y = linear('final_layer.linear', ln_mod(tok, shift, scale))     # (B, T, p^3 C)
    y = y.reshape(B, n, n, n, ps, ps, ps, C)
    return torch.einsum('bdhwijkc->bdihjwkc', y).reshape(B, R, R, R, C)
