"""3D diffusion transformer (DiT-XL/4 in 3D patches) over the DMTet grid.

A second score network beside the DDPM U-Net, built from DiT (Peebles &
Xie, arXiv:2212.09748; widths of ``DiT_XL_4`` in facebookresearch/DiT's
``models.py``) with DiT-3D's 3D patch embedding and 3D sin-cos positions
(Mo et al., arXiv:2307.01831). Input (B, R, R, R, C) channels-last, labels
(B,) in [0, N-1], the grid mask (1, R, R, R, 1); the output is the fp32
epsilon prediction, channels-last, as the U-Net's.

* Tokens: ``x_embedder.proj`` (Conv3d(C, D, p, stride p)) over x and
  ``mask_embedder.proj`` (Conv3d(1, D, p, stride p)) over the grid mask,
  added to every sample's tokens, in (d, h, w) row-major order, plus the
  fixed ``pos_embed`` (T, D): for token (d, h, w) [E(d), E(h), E(w)], each
  E(u) = [sin(u w_k), cos(u w_k)] for k < D/6, w_k = 10000^(-k/(D/6)).
* Condition c: ``t_embedder.mlp`` (Linear(256, D), SiLU, Linear(D, D)) on
  [cos(t f), sin(t f)], f_i = exp(-ln(1e4) i / 128), i < 128.
* Block (x depth): ``adaLN_modulation.1`` = Linear(D, 6D) on SiLU(c),
  chunked shift1, scale1, gate1, shift2, scale2, gate2; with LN a
  LayerNorm without affine (eps 1e-6) and mod(y, s, k) = y (1 + k) + s:
  x += gate1 attn.proj(MHA(attn.qkv(mod(LN x, shift1, scale1)))),
  x += gate2 mlp.fc2(GELU_tanh(mlp.fc1(mod(LN x, shift2, scale2)))).
  MHA: softmax(q k^T (D/H)^-1/2) v per head, no mask.
* Final layer: LN, mod with (shift, scale) of ``final_layer.adaLN_modulation.1``
  (Linear(D, 2D)), ``final_layer.linear`` (Linear(D, p^3 C)), unpatchified.

Departures from DiT: no class embedder (MeshDiffusion is unconditional per
category), ``learn_sigma`` off (epsilon only: the ancestral sampler reads
no variance), the mask embedding, 3D patches and positions.

Dtypes: the residual stream, the LayerNorm statistics, the modulation and
the gates are fp32; every Linear's operands and the attention's are the
compute dtype (bf16 on the card) with fp32 sums, their results in the
compute dtype. Each Linear keeps its weight and bias in the compute dtype
between calls (rebuilt when the weight changes, counted as
``rebuild.pack``). The attention is ``ops.dit_attention``, one call a block,
which takes its route by the rule of ``ops/_build.py`` (the hand-written
kernel on CUDA tensors; under autograd its plain version). The model has
no dropout, so ``train`` changes nothing.

With ``num_experts`` set (preset ``dit3d_moe_xl4_res64``, registered as
``dit3d_moe_xl4``), each block's MLP is DiT-MoE's sparse-expert layer
(Fei et al., arXiv:2407.11633; ``models/moe.py``), fed the fp32 modulated
tokens: x += gate2 moe(mod(LN x, shift2, scale2)).

A forward is a ``dit.forward`` span; each block a ``dit.block`` span
(attribute ``index``) holding a ``dit.attn`` and a ``dit.mlp`` span, or a
``dit.moe`` span in a sparse-expert block (``utils/trace.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import ops
from ..parallel import spatial
from ..utils import trace
from .layers import _Derived
from .moe import MoEGate, SparseMoeBlock
from .registry import register_alias, register_model

FREQ_DIM = 256          # the timestep's sinusoidal features (DiT's frequency_embedding_size)


def timestep_embedding(t: torch.Tensor, dim: int = FREQ_DIM,
                       max_period: float = 10000.0) -> torch.Tensor:
    """DiT's ``TimestepEmbedder.timestep_embedding``: [cos(t f), sin(t f)]
    with f_i = exp(-ln(max_period) i / (dim / 2)), fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def sincos_pos_embed_3d(dim: int, n: int) -> torch.Tensor:
    """(n^3, dim) fixed positions of an n x n x n token grid in (d, h, w)
    row-major order: DiT's 1-D sin-cos over a third of ``dim`` per axis."""
    if dim % 6:
        raise ValueError(f'the 3D sin-cos positions need a width divisible by 6, got {dim}')
    k = dim // 6
    omega = 1.0 / 10000.0 ** (torch.arange(k, dtype=torch.float64) / k)
    out = torch.outer(torch.arange(n, dtype=torch.float64), omega)
    e = torch.cat([torch.sin(out), torch.cos(out)], dim=1)          # (n, dim / 3)
    d, h, w = torch.meshgrid(torch.arange(n), torch.arange(n), torch.arange(n), indexing='ij')
    return torch.cat([e[d.reshape(-1)], e[h.reshape(-1)], e[w.reshape(-1)]], dim=1).float()


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, R, R, R, C) -> (B, T, p^3 C), each token's values in (i, j, k, c)
    order within its patch."""
    B, R, _, _, C = x.shape
    n = R // p
    x = x.reshape(B, n, p, n, p, n, p, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, n ** 3, p ** 3 * C)


def unpatchify(y: torch.Tensor, p: int, C: int) -> torch.Tensor:
    """The inverse of :func:`patchify`: (B, T, p^3 C) -> (B, R, R, R, C)."""
    B, T, _ = y.shape
    n = round(T ** (1 / 3))
    y = y.reshape(B, n, n, n, p, p, p, C).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return y.reshape(B, n * p, n * p, n * p, C)


class Linear(nn.Linear):
    """A Linear whose operands are ``dtype``: x, and the weight and bias
    cast once and kept between calls (rebuilt when the weight changes, as
    ``NIN.cast_weight`` is); under autograd the cast is recorded instead.
    Returns ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.dtype = dtype
        self._cast = _Derived('rebuild.pack')

    def operands(self):
        """(weight, bias) in the compute dtype."""
        if torch.is_grad_enabled():
            return self.weight.to(self.dtype), self.bias.to(self.dtype)
        return self._cast.get(self.weight, lambda: (self.weight.detach().to(self.dtype),
                                                    self.bias.detach().to(self.dtype)),
                              self.dtype, self.bias.data_ptr(), self.bias._version)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), *self.operands())


class PatchEmbed3D(nn.Module):
    """``proj``: Conv3d(C, D, p, stride p) over non-overlapping p^3
    patches, computed as a Linear over :func:`patchify`'s tokens."""

    def __init__(self, in_ch: int, dim: int, p: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.p, self.dtype = p, dtype
        self.proj = nn.Conv3d(in_ch, dim, p, stride=p)
        self._cast = _Derived('rebuild.pack')

    def operands(self):
        w, b = self.proj.weight, self.proj.bias

        def build():
            return (w.permute(0, 2, 3, 4, 1).reshape(w.shape[0], -1).to(self.dtype),
                    b.to(self.dtype))
        if torch.is_grad_enabled():
            return build()
        return self._cast.get(w, lambda: tuple(t.detach() for t in build()), self.dtype,
                              b.data_ptr(), b._version)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(patchify(x.to(self.dtype), self.p), *self.operands())


class TimestepEmbedder(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = nn.Sequential(Linear(FREQ_DIM, dim, dtype), nn.SiLU(), Linear(dim, dim, dtype))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(timestep_embedding(t)).float()


def modulate(y: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y (1 + scale) + shift, per sample, fp32."""
    return torch.addcmul(shift[:, None], y, 1.0 + scale[:, None])


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


class Attention(nn.Module):
    """``qkv`` (Linear(D, 3D)) -> per-head attention -> ``proj``."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.proj(ops.dit_attention(self.qkv(h), self.num_heads))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype)
        self.fc2 = Linear(hidden, dim, dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(h), approximate='tanh'))


class DiTBlock(nn.Module):
    """Attention, then the FFN: the dense ``mlp``, or with ``moe`` (the
    keyword arguments of :class:`SparseMoeBlock` but the width and dtype)
    DiT-MoE's sparse-expert ``moe``, fed the fp32 modulated tokens."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 dtype: torch.dtype = torch.float32, moe: Optional[dict] = None):
        super().__init__()
        self.attn = Attention(dim, num_heads, dtype)
        if moe:
            self.moe = SparseMoeBlock(dim, dtype=dtype, **moe)
        else:
            self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(dim, 6 * dim, dtype))
        self.ffn = 'moe' if moe else 'mlp'

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift1, scale1, gate1, shift2, scale2, gate2 = \
            self.adaLN_modulation(c).float().chunk(6, dim=-1)
        with trace.span('dit.attn'):
            y = self.attn(modulate(_layer_norm(x), shift1, scale1))
            x = torch.addcmul(x, gate1[:, None], y)
        with trace.span('dit.' + self.ffn):
            y = getattr(self, self.ffn)(modulate(_layer_norm(x), shift2, scale2))
            x = torch.addcmul(x, gate2[:, None], y)
        return x


class FinalLayer(nn.Module):
    def __init__(self, dim: int, p: int, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = Linear(dim, p ** 3 * channels, dtype)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(dim, 2 * dim, dtype))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c).float().chunk(2, dim=-1)
        return self.linear(modulate(_layer_norm(x), shift, scale))


@register_model(name='dit3d_xl4')
class DiT3D(nn.Module):
    """DiT over (B, R, R, R, C) grids in p^3 patches (module docstring);
    registered as ``dit3d_xl4``, the ``dit3d_xl4_res64`` preset's model, and
    as ``dit3d_moe_xl4``, the ``dit3d_moe_xl4_res64`` preset's: with
    ``num_experts`` > 0 every block's FFN is DiT-MoE's sparse-expert layer
    (``models/moe.py``; ``experts_per_token`` of them a token, width
    ``expert_hidden``, a shared expert of width ``shared_expert_hidden``)."""

    # checkpoints list this model's parameters in its own order (utils/checkpoint.py)
    own_param_order = True

    def __init__(self, image_size: int = 64, channels: int = 4, hidden_size: int = 1152,
                 depth: int = 28, num_heads: int = 16, mlp_ratio: float = 4.0,
                 patch_size: int = 4, centered: bool = True,
                 dtype: torch.dtype = torch.float32, num_experts: int = 0,
                 experts_per_token: int = 2, expert_hidden: int = 4608,
                 shared_expert_hidden: int = 2304):
        super().__init__()
        if image_size % patch_size or hidden_size % num_heads:
            raise ValueError(f'DiT3D: image_size {image_size} must be a multiple of patch_size '
                             f'{patch_size}, hidden_size {hidden_size} of num_heads {num_heads}')
        self.image_size, self.channels, self.patch_size = image_size, channels, patch_size
        self.hidden_size, self.num_heads, self.depth = hidden_size, num_heads, depth
        self.centered, self.dtype = centered, dtype
        D, p = hidden_size, patch_size
        self.x_embedder = PatchEmbed3D(channels, D, p, dtype)
        self.mask_embedder = PatchEmbed3D(1, D, p, dtype)
        self.t_embedder = TimestepEmbedder(D, dtype)
        self.register_buffer('pos_embed', sincos_pos_embed_3d(D, image_size // p),
                             persistent=False)
        moe = (dict(num_experts=num_experts, experts_per_token=experts_per_token,
                    expert_hidden=expert_hidden, shared_expert_hidden=shared_expert_hidden)
               if num_experts else None)
        self.blocks = nn.ModuleList(DiTBlock(D, num_heads, mlp_ratio, dtype, moe)
                                    for _ in range(depth))
        self.final_layer = FinalLayer(D, p, channels, dtype)

    @classmethod
    def from_config(cls, config, **overrides) -> 'DiT3D':
        m = config.model
        kw = dict(image_size=config.data.image_size, channels=config.data.num_channels,
                  hidden_size=m.hidden_size, depth=m.depth, num_heads=m.num_heads,
                  mlp_ratio=m.mlp_ratio, patch_size=m.patch_size,
                  centered=config.data.centered, dtype=getattr(torch, config.gpu.compute_dtype))
        for key in ('num_experts', 'experts_per_token', 'expert_hidden', 'shared_expert_hidden'):
            if key in m:
                kw[key] = m[key]
        kw.update(overrides)
        return cls(**kw)

    def reset_parameters_ddpm(self, generator: Optional[torch.Generator] = None) -> None:
        """DiT's own initialisation (``DiT.initialize_weights``), drawn from
        ``generator`` (the hook ``create_model`` calls): xavier-uniform
        Linears and patch projections (over their flattened fan-in), zero
        biases, normal(0.02) on the timestep MLP, zero adaLN modulations and
        a zero final layer; DiT-MoE's routers uniform in +-1/sqrt(D)."""
        def xavier(w):
            a = math.sqrt(6.0 / (w.shape[0] + w[0].numel()))
            w.uniform_(-a, a, generator=generator)

        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    xavier(mod.weight)
                    if mod.bias is not None:
                        mod.bias.zero_()
                elif isinstance(mod, MoEGate):
                    mod.reset_parameters(generator)
            for emb in (self.x_embedder, self.mask_embedder):
                xavier(emb.proj.weight)
                emb.proj.bias.zero_()
            for lin in (self.t_embedder.mlp[0], self.t_embedder.mlp[2]):
                lin.weight.normal_(0.0, 0.02, generator=generator)
            for lin in [b.adaLN_modulation[1] for b in self.blocks] + [
                    self.final_layer.adaLN_modulation[1], self.final_layer.linear]:
                lin.weight.zero_()
                lin.bias.zero_()

    def capture_routes(self, sink: Optional[list]) -> None:
        """While ``sink`` is a list, each forward appends every sparse-expert
        block's top-k expert ids (B T, k), in block order, on the device;
        None turns it off."""
        for block in self.blocks:
            if hasattr(block, 'moe'):
                block.moe.routes = sink

    @trace.span('dit.forward')
    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                mask: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        """x: (B, R, R, R, C) channels-last; labels: (B,) timestep labels in
        [0, N-1]; mask: (1, R, R, R, 1) grid mask (zeros when None).
        Returns the fp32 epsilon prediction, channels-last."""
        if x.ndim != 5 or x.shape[-1] != self.channels or x.shape[1] != self.image_size:
            raise ValueError(f'DiT3D: x {tuple(x.shape)}; expected (B, {self.image_size}, '
                             f'{self.image_size}, {self.image_size}, {self.channels})')
        if spatial.current() is not None:
            raise ValueError('DiT3D runs on one card: it has no depth-sharded forward')
        h = x if self.centered else 2 * x - 1.0
        if mask is None:
            mask = torch.zeros((1,) + tuple(x.shape[1:4]) + (1,), device=x.device)
        tok = self.x_embedder(h).float() + self.mask_embedder(mask).float()
        tok = tok + self.pos_embed
        c = self.t_embedder(labels)
        for i, block in enumerate(self.blocks):
            with trace.span('dit.block', index=i):
                tok = block(tok, c)
        out = self.final_layer(tok, c).float()
        return unpatchify(out, self.patch_size, self.channels)


register_alias('dit3d_moe_xl4', 'dit3d_xl4')
