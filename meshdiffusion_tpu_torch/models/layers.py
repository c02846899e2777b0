"""3D U-Net building blocks, channels-last (B, D, H, W, C).

Counterparts of ``meshdiffusion_tpu/models/layers.py`` (reference
``lib/diffusion/models/layers.py``). Parameters are fp32 and keep the
reference torch layout (Conv3d weight (O, I, kd, kh, kw), Linear weight
(out, in), NIN ``W`` (in, out)), so state_dicts carry across; activations
stay channels-last as in JAX, and the dtype flow is the JAX package's:

* convs and NIN/Dense compute in ``dtype`` (the compute dtype, bf16 on the
  card); a conv returns ``dtype``;
* GroupNorm statistics are fp32, the result returns in its input's dtype;
* NIN returns fp32 (bf16 operands, fp32 sums), so the residual sums that
  leave a block with a NIN shortcut are fp32.

Each ResnetBlock runs its two GroupNorm -> SiLU -> conv3^3 chains through
``ops.gn_silu_conv3d``, and a block whose width changes ends in
``ops.nin_residual``, its NIN shortcut and residual sum in one op; each op
takes its route (plain, kernel, or kernel forward with plain backward) by
the rule of ``ops/_build.py``. In training, dropout sits between the second
chain's SiLU and its conv; that chain then runs decomposed, as in the JAX
package.

Under ``parallel.spatial.sharded`` each rank holds a depth slab of the
grid, and the layers do what XLA's partitioner does for the JAX package's
sharded grid: every SAME conv reads its neighbours' boundary planes
(zeros only at the grid's ends), every GroupNorm normalises with the whole
grid's statistics, attention gathers its keys and values over the slabs.
The chains then run the conv's depth-halo mode
(``ops.gn_silu_conv3d_halo``) on the whole grid's ``a, b``, which the
statistics' moments mode feeds, and the shortcut composes ``NIN_0(x) + h``.
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


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           max_positions: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding of (possibly fractional) timestep labels;
    freq = exp(-log(1e4) * i / (half - 1)) (reference layers.py:542-556)."""
    assert timesteps.ndim == 1
    half_dim = embedding_dim // 2
    scale = math.log(max_positions) / (half_dim - 1)
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                   device=timesteps.device) * -scale)
    emb = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def ddpm_init_(weight: torch.Tensor, fan_in: int, fan_out: int, scale: float = 1.0,
               generator: Optional[torch.Generator] = None) -> None:
    """variance_scaling(scale, 'fan_avg', 'uniform'); scale 0 -> 1e-10
    (reference layers.py:54-91)."""
    scale = 1e-10 if scale == 0 else scale
    bound = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


class _Derived:
    """A tensor derived from a weight, kept between calls and rebuilt, counted
    as ``counter`` (``utils/trace.py``), when the weight changes: its storage,
    its version, or ``extra``."""
    __slots__ = ('counter', 'key', 'value')

    def __init__(self, counter: str):
        self.counter, self.key, self.value = counter, None, None

    def get(self, w: torch.Tensor, build, *extra) -> torch.Tensor:
        key = (w.data_ptr(), w._version) + extra
        if key != self.key:
            trace.count(self.counter)
            self.value, self.key = build(), key
        return self.value


class NIN(nn.Module):
    """1x1 'network-in-network' layer over the channel axis; returns fp32."""

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.W = nn.Parameter(torch.empty(in_dim, num_units))
        self.b = nn.Parameter(torch.zeros(num_units))
        self.init_scale = init_scale
        self.dtype = dtype
        self._cast = _Derived('rebuild.pack')

    def reset_parameters_ddpm(self, generator=None):
        ddpm_init_(self.W, *self.W.shape, self.init_scale, generator)
        nn.init.zeros_(self.b)

    def cast_weight(self) -> torch.Tensor:
        """``W`` in the compute dtype, contiguous: what ``ops.nin_residual``
        reads. Kept between calls and rebuilt when the weight changes, as
        ``Conv3D.packed`` is."""
        return self._cast.get(self.W, lambda: self.W.detach().to(self.dtype).contiguous(),
                              self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.nin_reference(x, self.W, self.b, self.dtype)


class Conv3D(nn.Conv3d):
    """Channels-last 3D conv in ``dtype`` with the torch weight layout."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 padding: int = -1, init_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=kernel // 2 if padding < 0 else padding)
        self.init_scale = init_scale
        self.dtype = dtype
        self._dhwio = _Derived('rebuild.dhwio')
        self._packed = _Derived('rebuild.pack')

    def reset_parameters_ddpm(self, generator=None):
        rf = math.prod(self.kernel_size)
        ddpm_init_(self.weight, self.in_channels * rf, self.out_channels * rf,
                   self.init_scale, generator)
        nn.init.zeros_(self.bias)

    def dhwio(self) -> torch.Tensor:
        """The weight in the JAX kernel layout (kd, kh, kw, I, O), contiguous
        in the compute dtype: the layout the plain GN -> SiLU -> conv reads
        (the conv kernel reads :meth:`packed`). Kept between
        calls and rebuilt when the weight changes (its storage or version),
        so the 74 ResnetBlock convs of a forward do not re-cast and
        re-transpose their weights every call."""
        w = self.weight
        return self._dhwio.get(
            w, lambda: w.detach().permute(2, 3, 4, 1, 0).to(self.dtype).contiguous(), self.dtype)

    def packed(self) -> torch.Tensor:
        """The weight as the conv kernel's B tiles (``ops.pack_conv_weights``:
        per (N block, 64-channel chunk, tap) one contiguous, swizzled bf16
        tile, copied into shared memory by one bulk copy). Kept between calls
        and rebuilt when the weight changes, as :meth:`dhwio` is."""
        return self._packed.get(self.weight, lambda: ops.pack_conv_weights(self.dhwio()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, padding = self.dtype, self.padding
        if spatial.current() is not None and padding[0]:
            # a depth slab: its neighbours' planes in the place of D's padding
            x = spatial.pad_depth(x, padding[0], padding[0])
            padding = (0,) + tuple(padding[1:])
        y = F.conv3d(x.permute(0, 4, 1, 2, 3).to(dt), self.weight.to(dt), self.bias.to(dt),
                     self.stride, padding)
        return y.permute(0, 2, 3, 4, 1)


def _linear_in(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=...): operands and bias in ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class ResnetBlockDDPM(nn.Module):
    """GN-SiLU-conv / +temb / GN-SiLU-dropout-conv(zero init) with a NIN
    shortcut when the width changes (reference layers.py:646-689); dropout
    acts only when ``train``."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 temb_dim: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        out_ch = out_ch or in_ch
        self.in_ch, self.out_ch = in_ch, out_ch
        self.dtype, self.dropout = dtype, dropout
        self.GroupNorm_0 = nn.GroupNorm(32, in_ch, eps=1e-6)
        self.Conv_0 = Conv3D(in_ch, out_ch, 3, dtype=dtype)
        if temb_dim is not None:
            self.Dense_0 = nn.Linear(temb_dim, out_ch)
        self.GroupNorm_1 = nn.GroupNorm(32, out_ch, eps=1e-6)
        self.Conv_1 = Conv3D(out_ch, out_ch, 3, init_scale=0.0, dtype=dtype)
        if in_ch != out_ch:
            self.NIN_0 = NIN(in_ch, out_ch, dtype=dtype)

    @trace.span('unet.resblock')
    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        dt = self.dtype
        grad = torch.is_grad_enabled()
        sh = spatial.current()

        def chain(x, gn, conv, drop=0.0):
            # under autograd the live weight: dhwio() is a detached copy
            kernel = conv.weight.permute(2, 3, 4, 1, 0) if grad else conv.dhwio()
            if sh is not None:
                # this rank's depth slab: the whole grid's statistics, then the
                # conv over the slab with its neighbours' boundary planes
                a, b = spatial.gn_affine(x, gn.weight, gn.bias, 32, 1e-6)
                if not drop:
                    return ops.gn_silu_conv3d_halo(spatial.halo(x.contiguous(), 1, 1), a, b,
                                                   kernel, conv.bias, sh.halo_sizes(1), dt,
                                                   packed=conv.packed())
                h = F.silu(x.float() * a[:, None, None, None] + b[:, None, None, None])
                h = F.dropout(h.to(x.dtype), drop, training=True).to(dt)
                return (ops.conv3d_depth_valid(spatial.pad_depth(h, 1, 1), kernel.to(dt))
                        + conv.bias.to(dt))
            if drop:
                # dropout between SiLU and the conv: the decomposed chain of
                # the JAX package's _fused_body, the conv outside any kernel
                h = F.dropout(ops.groupnorm_silu_reference(x, gn.weight, gn.bias, 32, 1e-6),
                              drop, training=True)
                return ops.conv3d_same(h.to(dt), kernel.to(dt)) + conv.bias.to(dt)
            # the conv kernel reads a contiguous x (under autograd a conv's
            # output, the stem's or a downsample's, can come back in another layout)
            return ops.gn_silu_conv3d(x.contiguous(), gn.weight, gn.bias, kernel, conv.bias,
                                      32, 1e-6, dt, packed=conv.packed())

        h = chain(x, self.GroupNorm_0, self.Conv_0)
        if temb is not None:
            t = _linear_in(F.silu(temb), self.Dense_0, dt)
            h = h + t[:, None, None, None, :].to(h.dtype)
        h = chain(h, self.GroupNorm_1, self.Conv_1, self.dropout if train else 0.0)
        if self.in_ch == self.out_ch:
            return x + h
        nin = self.NIN_0
        if sh is not None:
            return nin(x) + h
        # the live weight where autograd records it: cast_weight() is a detached copy
        W = nin.W if grad and nin.W.requires_grad else nin.cast_weight()
        return ops.nin_residual(x.contiguous(), W, nin.b, h, dt)


class AttnBlock(nn.Module):
    """Self-attention over the flattened volume as two batched matmuls
    (reference layers.py:585-608; JAX einsums with fp32 results)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(32, channels, eps=1e-6)
        self.NIN_0 = NIN(channels, channels, dtype=dtype)
        self.NIN_1 = NIN(channels, channels, dtype=dtype)
        self.NIN_2 = NIN(channels, channels, dtype=dtype)
        self.NIN_3 = NIN(channels, channels, init_scale=0.0, dtype=dtype)

    @trace.span('unet.attn')
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, D, H, W, C = x.shape
        if spatial.current() is not None:
            # a depth slab: the whole grid's statistics; this slab's queries
            # against every slab's keys and values
            h = spatial.groupnorm(x, self.GroupNorm_0)
            k, v = (spatial.gather_depth(nin(h)) for nin in (self.NIN_1, self.NIN_2))
        else:
            h = ops.groupnorm_reference(x, self.GroupNorm_0.weight, self.GroupNorm_0.bias)
            k, v = self.NIN_1(h), self.NIN_2(h)
        q = self.NIN_0(h).reshape(B, -1, C)
        k, v = k.reshape(B, -1, C), v.reshape(B, -1, C)
        w = torch.matmul(q, k.transpose(1, 2)) * (C ** -0.5)
        h = torch.matmul(torch.softmax(w, dim=-1), v).reshape(B, D, H, W, C)
        return x + self.NIN_3(h)


class Upsample(nn.Module):
    """Nearest x2 then a SAME 3^3 conv (reference layers.py:611-623)."""

    def __init__(self, channels: int, with_conv: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.Conv_0 = Conv3D(channels, channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.repeat_interleave(2, 1).repeat_interleave(2, 2).repeat_interleave(2, 3)
        return self.Conv_0(h) if self.with_conv else h


class Downsample(nn.Module):
    """Pad (0, 1) on the right of each spatial dim, then a VALID stride-2
    3^3 conv (reference layers.py:626-643); or a 2^3 average pool."""

    def __init__(self, channels: int, with_conv: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.Conv_0 = Conv3D(channels, channels, 3, stride=2, padding=0, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.with_conv and spatial.current() is not None:
            # a depth slab (of even depth): D's right pad is the next slab's
            # first plane, a zero plane on the last slab
            return self.Conv_0(F.pad(spatial.pad_depth(x, 0, 1), (0, 0, 0, 1, 0, 1)))
        if self.with_conv:
            return self.Conv_0(F.pad(x, (0, 0, 0, 1, 0, 1, 0, 1)))
        y = F.avg_pool3d(x.permute(0, 4, 1, 2, 3), 2, 2)
        return y.permute(0, 2, 3, 4, 1)
