"""Plain fp32 sparse-expert diffusion transformer: DiT-MoE's block (Fei et
al., "Scaling Diffusion Transformers to 16 Billion Parameters",
arXiv:2407.11633; ``SparseMoeBlock``, ``MoEGate`` and ``MoeMLP`` of
feizc/DiT-MoE's ``models.py``) in the 3D DiT of ``reference/dit.py``, written
from the published equations.

The model is ``reference/dit.py``'s with each block's MLP replaced by the
sparse-expert layer, fed the modulated tokens h = LN(x) (1 + scale2) +
shift2 (N, D):

* router: p = softmax(h W_r^T), W_r (E, D) ``moe.gate.weight``, no bias;
  each token's top k experts by p, weighted by their p as they are (no
  renormalisation over the k: ``norm_topk_prob`` off);
* expert e: SwiGLU, Wd_e (SiLU(Wg_e h) * (Wu_e h)), hidden width F, no
  biases (``moe.experts.{e}.{gate,up,down}_proj.weight``);
* shared expert S: the same SwiGLU of width Fs
  (``moe.shared_experts.{gate,up,down}_proj.weight``), every token;
* y = sum over the k slots of p_e E_e(h), slot by slot, then + S(h);
  x += gate2 y.

Departures from DiT-MoE (beside ``reference/dit.py``'s: no class embedder,
epsilon only, the mask embedding, 3D patches and positions): no
load-balancing loss (sampling computes none), no token dropped, and the
router's logits in fp32 like everything here.

:func:`forward` returns eps and, for each block, the reference's own top k
experts of every token and the gap between its k-th and (k+1)-th
probability (how near the token was to another choice). Given ``routes``
(a (N, k) tensor of expert ids a block), each block uses those experts,
weighted by the reference's own probabilities at them: the reference then
follows a program's routing, and its eps can be held to the program's
while the routes are compared apart.

:func:`make_weights` draws every parameter from a seed on the device, one
tensor after another from one generator: Linears, the router and the patch
projections xavier-uniform, biases uniform in +-0.05, the adaLN modulations'
biases in +-0.5 (as ``reference/dit.py``, so that gates are not zero), and
the routed experts' down projections at E / k = 4 times xavier's bound. A
token's two slots are weighted by their softmax probabilities (~0.45 together
over 8 experts); at xavier's bound alone they carried ~7 % of the layer's
output beside the shared expert, and the experts computed in fp8 moved eps
by less than the program's own rounding does. At E / k they carry about as
much as the shared expert, as a trained router's experts would, and the
comparison sees their arithmetic.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import dit
from .dit import BIAS, MOD_BIAS, Quant, pos_embed, timestep_embedding


def arch(cfg: dict) -> dict:
    """The architecture's numbers from a configuration file's dict:
    ``reference/dit.py``'s and the experts' (E, k, F, Fs)."""
    a = dit.arch(cfg)
    m = cfg['model']
    a.update(E=m['num_experts'], k=m['experts_per_token'], F=m['expert_hidden'],
             Fs=m['shared_expert_hidden'])
    return a


def param_specs(a: dict) -> List[Tuple[str, Tuple[int, ...], str, int, int]]:
    """Every parameter as (key, shape, kind, fan_in, fan_out), in the
    program's state_dict order: ``reference/dit.py``'s with each block's
    ``mlp`` replaced by ``moe`` (experts, router, shared expert); kind
    'expert_down' for the routed experts' down projections."""
    D = a['D']

    def swiglu(key, hidden):
        return [(f'{key}.gate_proj.weight', (hidden, D), 'weight', D, hidden),
                (f'{key}.up_proj.weight', (hidden, D), 'weight', D, hidden),
                (f'{key}.down_proj.weight', (D, hidden), 'weight', hidden, D)]
    out = []
    for spec in dit.param_specs(a):
        key = spec[0]
        if not (key.startswith('blocks.') and '.mlp.' in key):
            out.append(spec)
        elif key.endswith('.mlp.fc1.weight'):
            blk = key[:-len('.mlp.fc1.weight')] + '.moe'
            for e in range(a['E']):
                gate, up, down = swiglu(f'{blk}.experts.{e}', a['F'])
                out += [gate, up, down[:2] + ('expert_down',) + down[3:]]
            out.append((f'{blk}.gate.weight', (a['E'], D), 'weight', D, a['E']))
            out += swiglu(f'{blk}.shared_experts', a['Fs'])
    return out


def make_weights(a: dict, seed: int, device) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(flat fp32 buffer, {key: view of it}) for architecture ``a``, drawn
    from ``seed`` on ``device`` into the buffer in place."""
    specs = param_specs(a)
    sizes = [math.prod(s[1]) for s in specs]
    flat = torch.empty(sum(sizes), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out, o = {}, 0
    for (key, shape, kind, fi, fo), size in zip(specs, sizes):
        if kind in ('weight', 'expert_down'):
            b = math.sqrt(6.0 / (fi + fo)) * (a['E'] / a['k'] if kind == 'expert_down' else 1)
        else:
            b = BIAS if kind == 'bias' else MOD_BIAS
        out[key] = flat[o:o + size].view(shape).uniform_(-b, b, generator=gen)
        o += size
    return flat, out


def _swiglu(p, key, h, q):
    g = F.linear(q(h), q(p[key + '.gate_proj.weight']))
    u = F.linear(q(h), q(p[key + '.up_proj.weight']))
    return F.linear(q(F.silu(g) * u), q(p[key + '.down_proj.weight']))


def moe_layer(p: Dict[str, torch.Tensor], a: dict, key: str, h: torch.Tensor,
              route: Optional[torch.Tensor] = None, q: Optional[Quant] = None):
    """(y (N, D), own top k (N, k), gap (N,)) of the sparse-expert layer
    ``key`` on the modulated tokens h (N, D); with ``route`` (N, k) those
    experts are used, at the reference's own probabilities."""
    q = q or dit._ident
    E, k = a['E'], a['k']
    probs = torch.softmax(F.linear(q(h), q(p[key + '.gate.weight'])), dim=-1)
    best = torch.topk(probs, min(k + 1, E), dim=-1)
    top = best.indices[:, :k]
    gap = (best.values[:, k - 1] - best.values[:, k]) if k < E else torch.ones_like(probs[:, 0])
    use = top if route is None else route.to(h.device).long()
    w = probs.gather(1, use)
    y = None
    for j in range(k):
        slot = torch.zeros_like(h)
        for e in range(E):
            rows = (use[:, j] == e).nonzero().squeeze(1)
            if rows.numel():
                slot[rows] = w[rows, j, None] * _swiglu(p, f'{key}.experts.{e}', h[rows], q)
        y = slot if y is None else y + slot
    return y + _swiglu(p, key + '.shared_experts', h, q), top, gap


def forward(p: Dict[str, torch.Tensor], a: dict, x: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor, routes: Optional[List[torch.Tensor]] = None,
            q: Optional[Quant] = None):
    """(eps (B, R, R, R, C), {'top': [(B T, k)] a block, 'gap': [(B T,)] a
    block}) of x (B, R, R, R, C) at float timestep labels (B,), with the grid
    mask (R, R, R); ``routes`` [(B T, k)] a block, tokens in (sample, d, h,
    w) order, or None for the reference's own."""
    q = q or dit._ident
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
    info = {'top': [], 'gap': []}
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
        y, top, gap = moe_layer(p, a, key + '.moe', ln_mod(tok, shift2, scale2).reshape(-1, D),
                                None if routes is None else routes[i], q)
        info['top'].append(top)
        info['gap'].append(gap)
        tok = tok + gate2[:, None] * y.reshape(tok.shape)
        del y
    shift, scale = linear('final_layer.adaLN_modulation.1', sc).chunk(2, dim=-1)
    y = linear('final_layer.linear', ln_mod(tok, shift, scale))     # (B, T, p^3 C)
    y = y.reshape(B, n, n, n, ps, ps, ps, C)
    return torch.einsum('bdhwijkc->bdihjwkc', y).reshape(B, R, R, R, C), info
