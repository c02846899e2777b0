"""FLUX.1's MMDiT as a text-conditioned score network over the DMTet grid.

FLUX.1 (Black Forest Labs; github.com/black-forest-labs/flux,
``src/flux/model.py``, ``modules/layers.py``, ``math.py``; the widths of
``configs["flux-dev"]`` in ``util.py``) in 3D patches: a dual-stream stage
(``double_blocks``, separate weights for the grid's tokens and the
condition's) and then a single-stream stage (``single_blocks``) over the
joint sequence, with QK-RMSNorm and 3-axis rotary positions in every
block's attention. Input (B, R, R, R, C) channels-last, labels (B,) in [0,
N-1], the grid mask (1, R, R, R, 1), and the condition as keywords: ``txt``
(B, context_len, context_in_dim) token features, ``y`` (B, vec_in_dim) a
pooled vector, ``guidance`` (B,). The output is the fp32 epsilon
prediction, channels-last, as the U-Net's.

* img tokens: ``img_in`` (Linear(p^3 C, D)) over :func:`.dit3d.patchify`'s
  tokens, plus ``mask_embedder.proj`` (Conv3d(1, D, p, stride p)) over the
  grid mask; txt tokens: ``txt_in`` (Linear(context_in_dim, D)).
* vec = time_in(E(labels)) + guidance_in(E(1000 guidance)) +
  vector_in(y), each an ``MLPEmbedder`` (``in_layer``, SiLU,
  ``out_layer``), E(t) = [cos(t f), sin(t f)], f_i = exp(-ln(1e4) i / 128).
* Double-stream block, for each stream s of (img, txt): (shift1, scale1,
  gate1, shift2, scale2, gate2) = ``{s}_mod.lin``(SiLU(vec)); q, k, v =
  ``{s}_attn.qkv``((1 + scale1) LN(x) + shift1); q and k through
  ``{s}_attn.norm`` (an RMSNorm over dh with a learned scale, eps 1e-6);
  joint attention over cat(txt, img) with RoPE on q and k, split back; x +=
  gate1 ``{s}_attn.proj``(a); x += gate2 ``{s}_mlp``((1 + scale2) LN(x) +
  shift2), the MLP Linear(D, 4D), GELU-tanh, Linear(4D, D).
* Single-stream block over x = cat(txt, img): (shift, scale, gate) =
  ``modulation.lin``(SiLU(vec)); h = ``linear1``((1 + scale) LN(x) + shift),
  (B, L, 3D + 4D); q, k, v from its first 3D through ``norm`` and RoPE into
  attention; x += gate ``linear2``(cat(a, GELU_tanh(h[3D:]))).
* RoPE: a head's dh = 128 values are 64 adjacent pairs; pairs 0 .. 7 turn
  by position axis 0, 8 .. 35 by axis 1, 36 .. 63 by axis 2 (``axes_dim``
  16, 56, 56); pair j of an axis of width d turns by pos theta^(-2 j / d).
  Image token (d, h, w) of the n^3 grid has positions (d, h, w), text
  tokens (0, 0, 0). The (cos, sin) table is made in float64 and kept by
  shape (:func:`rope_table`).
* Final layer on the img tokens: (shift, scale) =
  ``final_layer.adaLN_modulation.1``(SiLU(vec)); ``final_layer.linear``((1
  + scale) LN(x) + shift), unpatchified. LN is a LayerNorm without affine,
  eps 1e-6, everywhere.

Departures from FLUX: 3D patches of the 4-channel grid (p^3 C values a
token, in place of 2 x 2 patches of 16 latent channels) and 3D positions;
the mask embedding; an epsilon output for the VP SDE in place of the flow's
velocity, with the labels t x 999 in place of FLUX's 1000 t; the RMSNorm's
and RoPE's arithmetic in fp32 with one rounding (FLUX rounds to bf16 after
the RMS, the scale and the rotation).

Dtypes follow ``models/dit3d.py``: the residual streams, LayerNorm
statistics, modulations and gates are fp32; every Linear's operands are
the compute dtype (bf16 on the card) with fp32 sums, its result in the
compute dtype, its weight cast once and kept (``rebuild.pack``). Per block,
one ``ops.qk_norm_rope`` call writes the joint (B, L, 3D) q, k, v and one
``ops.dit_attention`` call (head dimension 128) reads it; each takes its
route by the rule of ``ops/_build.py``. The txt stream is recomputed
through every double block at every step (its modulation depends on t).

A forward is a ``flux.forward`` span holding ``flux.cond`` (vec and
``txt_in``), one ``flux.double`` or ``flux.single`` span a block
(attribute ``index``), each holding ``flux.attn`` (the qkv Linears or
``linear1``, ``qk_norm_rope``, the attention, the projections) and
``flux.mlp`` (the MLPs, or the GELU, the concatenation and ``linear2``)
(``utils/trace.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import ops
from ..parallel import spatial
from ..utils import trace
from .dit3d import (FREQ_DIM, Linear, PatchEmbed3D, _layer_norm, modulate, patchify,
                    timestep_embedding, unpatchify)
from .registry import register_model

GUIDANCE_FACTOR = 1000.0      # FLUX's time_factor, applied to the guidance scale


def rope_table(ids: torch.Tensor, axes_dim: Sequence[int], theta: float) -> torch.Tensor:
    """(L, sum(axes_dim) / 2, 2) fp32 (cos, sin) of each position's pairs:
    FLUX's ``EmbedND`` / ``math.rope`` from ``ids`` (L, len(axes_dim)), in
    float64 until the end."""
    angles = []
    for a, d in enumerate(axes_dim):
        omega = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=ids.device) / d)
        angles.append(ids[:, a, None].double() * omega[None])
    ang = torch.cat(angles, dim=-1)
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1).float()


def position_ids(n: int, txt_len: int, device=None) -> torch.Tensor:
    """(txt_len + n^3, 3) position ids: the text tokens (0, 0, 0), then image
    token (d, h, w) of the n^3 grid in row-major order."""
    d, h, w = torch.meshgrid(*(torch.arange(n, device=device),) * 3, indexing='ij')
    img = torch.stack([d, h, w], dim=-1).reshape(-1, 3)
    return torch.cat([torch.zeros((txt_len, 3), dtype=img.dtype, device=device), img])


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_layer = Linear(in_dim, dim, dtype)
        self.out_layer = Linear(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_layer(F.silu(self.in_layer(x))).float()


class RMSNorm(nn.Module):
    """A learned ``scale`` over the head dimension; the normalisation itself
    runs in ``ops.qk_norm_rope``."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))


class QKNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = RMSNorm(dim)
        self.key_norm = RMSNorm(dim)

    def scales(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.query_norm.scale, self.key_norm.scale


class SelfAttention(nn.Module):
    """A double block stream's ``qkv``, ``norm`` and ``proj``."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.norm = QKNorm(dim // num_heads)
        self.proj = Linear(dim, dim, dtype)


class Modulation(nn.Module):
    """``lin`` (Linear(D, n D)) on SiLU(vec), chunked into n fp32 (B, D)."""

    def __init__(self, dim: int, n: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = n
        self.lin = Linear(dim, n * dim, dtype)

    def forward(self, vec: torch.Tensor):
        return self.lin(F.silu(vec)).float().chunk(self.n, dim=-1)


def _mlp(dim: int, hidden: int, dtype: torch.dtype) -> nn.Sequential:
    return nn.Sequential(Linear(dim, hidden, dtype), nn.GELU(approximate='tanh'),
                         Linear(hidden, dim, dtype))


class DoubleStreamBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        hidden = int(dim * mlp_ratio)
        for s in ('img', 'txt'):
            setattr(self, s + '_mod', Modulation(dim, 6, dtype))
            setattr(self, s + '_attn', SelfAttention(dim, num_heads, dtype))
            setattr(self, s + '_mlp', _mlp(dim, hidden, dtype))

    def forward(self, img: torch.Tensor, txt: torch.Tensor, vec: torch.Tensor,
                pe: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = self.img_mod(vec)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = self.txt_mod(vec)
        Tt = txt.shape[1]
        with trace.span('flux.attn'):
            t_qkv = self.txt_attn.qkv(modulate(_layer_norm(txt), t_sh1, t_sc1))
            i_qkv = self.img_attn.qkv(modulate(_layer_norm(img), i_sh1, i_sc1))
            joint = ops.qk_norm_rope(t_qkv, *self.txt_attn.norm.scales(), pe, self.num_heads,
                                     i_qkv, *self.img_attn.norm.scales())
            del t_qkv, i_qkv
            a = ops.dit_attention(joint, self.num_heads)
            del joint
            txt = torch.addcmul(txt, t_g1[:, None], self.txt_attn.proj(a[:, :Tt]))
            img = torch.addcmul(img, i_g1[:, None], self.img_attn.proj(a[:, Tt:]))
            del a
        with trace.span('flux.mlp'):
            img = torch.addcmul(img, i_g2[:, None],
                                self.img_mlp(modulate(_layer_norm(img), i_sh2, i_sc2)))
            txt = torch.addcmul(txt, t_g2[:, None],
                                self.txt_mlp(modulate(_layer_norm(txt), t_sh2, t_sc2)))
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dim = num_heads, dim
        self.hidden = int(dim * mlp_ratio)
        self.linear1 = Linear(dim, 3 * dim + self.hidden, dtype)
        self.linear2 = Linear(dim + self.hidden, dim, dtype)
        self.norm = QKNorm(dim // num_heads)
        self.modulation = Modulation(dim, 3, dtype)

    def forward(self, x: torch.Tensor, vec: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
        shift, scale, gate = self.modulation(vec)
        with trace.span('flux.attn'):
            h = self.linear1(modulate(_layer_norm(x), shift, scale))
            joint = ops.qk_norm_rope(h, *self.norm.scales(), pe, self.num_heads)
            a = ops.dit_attention(joint, self.num_heads)
            del joint
        with trace.span('flux.mlp'):
            y = self.linear2(torch.cat([a, F.gelu(h[..., 3 * self.dim:], approximate='tanh')],
                                       dim=-1))
            del a, h
            x = torch.addcmul(x, gate[:, None], y)
        return x


class LastLayer(nn.Module):
    def __init__(self, dim: int, out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = Linear(dim, out, dtype)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(dim, 2 * dim, dtype))

    def forward(self, x: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(vec).float().chunk(2, dim=-1)
        return self.linear(modulate(_layer_norm(x), shift, scale))


@register_model(name='flux3d')
class Flux3D(nn.Module):
    """FLUX.1's MMDiT over (B, R, R, R, C) grids in p^3 patches (module
    docstring); registered as ``flux3d``, the ``flux3d_dev_res64`` preset's
    model."""

    # checkpoints list this model's parameters in its own order (utils/checkpoint.py)
    own_param_order = True

    def __init__(self, image_size: int = 64, channels: int = 4, hidden_size: int = 3072,
                 num_heads: int = 24, mlp_ratio: float = 4.0, depth: int = 19,
                 depth_single_blocks: int = 38, axes_dim: Sequence[int] = (16, 56, 56),
                 theta: float = 10000.0, context_in_dim: int = 4096, context_len: int = 512,
                 vec_in_dim: int = 768, patch_size: int = 4, centered: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dh = hidden_size // num_heads
        if image_size % patch_size or hidden_size % num_heads or sum(axes_dim) != dh:
            raise ValueError(f'Flux3D: image_size {image_size} must be a multiple of patch_size '
                             f'{patch_size}, hidden_size {hidden_size} of num_heads {num_heads}, '
                             f'and axes_dim {tuple(axes_dim)} must sum to the head dimension {dh}')
        self.image_size, self.channels, self.patch_size = image_size, channels, patch_size
        self.hidden_size, self.num_heads = hidden_size, num_heads
        self.depth, self.depth_single_blocks = depth, depth_single_blocks
        self.axes_dim, self.theta = tuple(axes_dim), float(theta)
        self.context_in_dim, self.context_len = context_in_dim, context_len
        self.vec_in_dim = vec_in_dim
        self.centered, self.dtype = centered, dtype
        D, p = hidden_size, patch_size
        self.img_in = Linear(p ** 3 * channels, D, dtype)
        self.mask_embedder = PatchEmbed3D(1, D, p, dtype)
        self.txt_in = Linear(context_in_dim, D, dtype)
        self.time_in = MLPEmbedder(FREQ_DIM, D, dtype)
        self.vector_in = MLPEmbedder(vec_in_dim, D, dtype)
        self.guidance_in = MLPEmbedder(FREQ_DIM, D, dtype)
        self.double_blocks = nn.ModuleList(DoubleStreamBlock(D, num_heads, mlp_ratio, dtype)
                                           for _ in range(depth))
        self.single_blocks = nn.ModuleList(SingleStreamBlock(D, num_heads, mlp_ratio, dtype)
                                           for _ in range(depth_single_blocks))
        self.final_layer = LastLayer(D, p ** 3 * channels, dtype)
        self._pe: Dict[tuple, torch.Tensor] = {}

    @classmethod
    def from_config(cls, config, **overrides) -> 'Flux3D':
        m = config.model
        kw = dict(image_size=config.data.image_size, channels=config.data.num_channels,
                  centered=config.data.centered, dtype=getattr(torch, config.gpu.compute_dtype))
        for key in ('hidden_size', 'num_heads', 'mlp_ratio', 'depth', 'depth_single_blocks',
                    'axes_dim', 'theta', 'context_in_dim', 'context_len', 'vec_in_dim',
                    'patch_size'):
            kw[key] = m[key]
        kw.update(overrides)
        return cls(**kw)

    def reset_parameters_ddpm(self, generator: Optional[torch.Generator] = None) -> None:
        """FLUX publishes no initialisation (it loads its checkpoints); this is
        DiT's adaLN-Zero one, drawn from ``generator`` (the hook
        ``create_model`` calls): xavier-uniform Linears and the mask
        projection, zero biases, normal(0.02) on the embedders' MLPs, the
        RMSNorm scales 1, and zero modulations and final layer."""
        def xavier(w):
            a = math.sqrt(6.0 / (w.shape[0] + w[0].numel()))
            w.uniform_(-a, a, generator=generator)

        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    xavier(mod.weight)
                    mod.bias.zero_()
                elif isinstance(mod, RMSNorm):
                    mod.scale.fill_(1.0)
            xavier(self.mask_embedder.proj.weight)
            self.mask_embedder.proj.bias.zero_()
            for emb in (self.time_in, self.vector_in, self.guidance_in):
                for lin in (emb.in_layer, emb.out_layer):
                    lin.weight.normal_(0.0, 0.02, generator=generator)
            mods = [b.img_mod.lin for b in self.double_blocks] + \
                [b.txt_mod.lin for b in self.double_blocks] + \
                [b.modulation.lin for b in self.single_blocks] + \
                [self.final_layer.adaLN_modulation[1], self.final_layer.linear]
            for lin in mods:
                lin.weight.zero_()
                lin.bias.zero_()

    def draw_condition(self, batch: int, generator: torch.Generator,
                       guidance: float) -> Dict[str, torch.Tensor]:
        """A condition of standard normal features on the generator's device:
        ``txt`` (batch, context_len, context_in_dim), ``y`` (batch,
        vec_in_dim), and ``guidance`` (batch,) at the given scale."""
        dev = generator.device
        return dict(txt=torch.randn((batch, self.context_len, self.context_in_dim),
                                    generator=generator, device=dev),
                    y=torch.randn((batch, self.vec_in_dim), generator=generator, device=dev),
                    guidance=torch.full((batch,), float(guidance), device=dev))

    def rope(self, txt_len: int, device) -> torch.Tensor:
        """The (txt_len + n^3, dh / 2, 2) rotation table, made once a shape."""
        key = (txt_len, device)
        if key not in self._pe:
            n = self.image_size // self.patch_size
            self._pe[key] = rope_table(position_ids(n, txt_len, device), self.axes_dim,
                                       self.theta).contiguous()
        return self._pe[key]

    @trace.span('flux.forward')
    def forward(self, x: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False, *, txt: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None,
                guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, R, R, R, C) channels-last; labels: (B,) timestep labels in
        [0, N-1]; mask: (1, R, R, R, 1) grid mask (zeros when None); txt (B,
        T_txt, context_in_dim), y (B, vec_in_dim) and guidance (B,): the
        condition. Returns the fp32 epsilon prediction, channels-last."""
        if x.ndim != 5 or x.shape[-1] != self.channels or x.shape[1] != self.image_size:
            raise ValueError(f'Flux3D: x {tuple(x.shape)}; expected (B, {self.image_size}, '
                             f'{self.image_size}, {self.image_size}, {self.channels})')
        B = x.shape[0]
        if (txt is None or y is None or txt.shape[0] != B or txt.shape[-1] != self.context_in_dim
                or y.shape != (B, self.vec_in_dim) or guidance is None or guidance.shape != (B,)):
            raise ValueError(f'Flux3D needs its condition: txt (B, T, {self.context_in_dim}), '
                             f'y (B, {self.vec_in_dim}), guidance (B,)')
        if spatial.current() is not None:
            raise ValueError('Flux3D runs on one card: it has no depth-sharded forward')
        h = x if self.centered else 2 * x - 1.0
        if mask is None:
            mask = torch.zeros((1,) + tuple(x.shape[1:4]) + (1,), device=x.device)
        with trace.span('flux.cond'):
            vec = (self.time_in(timestep_embedding(labels)) + self.vector_in(y)
                   + self.guidance_in(timestep_embedding(GUIDANCE_FACTOR * guidance)))
            txt = self.txt_in(txt).float()
        img = self.img_in(patchify(h, self.patch_size)).float() + self.mask_embedder(mask).float()
        pe = self.rope(txt.shape[1], x.device)
        for i, block in enumerate(self.double_blocks):
            with trace.span('flux.double', index=i):
                img, txt = block(img, txt, vec, pe)
        Tt = txt.shape[1]
        x = torch.cat([txt, img], dim=1)
        del txt, img
        for i, block in enumerate(self.single_blocks):
            with trace.span('flux.single', index=i):
                x = block(x, vec, pe)
        out = self.final_layer(x[:, Tt:], vec).float()
        return unpatchify(out, self.patch_size, self.channels)
