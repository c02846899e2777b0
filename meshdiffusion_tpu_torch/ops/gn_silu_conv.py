"""Fused GroupNorm + SiLU + 3x3x3 SAME conv, channels-last, forward only.

Replaces the TPU kernel ``meshdiffusion_tpu/ops/gn_silu_conv.py``
(``gn_silu_conv3d_pallas``, pallas_call at :171): the two GN -> SiLU ->
conv chains of every U-Net ResnetBlock. The GroupNorm statistics come
from the one-launch ``gn_stats`` kernel (:func:`.groupnorm.gn_affine`), read
at x's own precision (fp32 for the up path's residual sums; that pass also
writes x rounded to bf16, the conv's operand), folded into a per-(batch,
channel) affine; the CUDA kernel ``csrc/gn_silu_conv3d.cu``
(wgmma, a bulk-copy weight ring, the next channel chunk's normalized input
brick built while the current one's products run) then computes
``silu(x*a + b)`` once per input element and the conv as an implicit GEMM
with fp32 sums. The notes in that file say what bounds it and what its
design does; :func:`_plan` picks its tiling, split, grid and the route of
its A operand, and :func:`pack_conv_weights` lays the weights out as its B
tiles.

Two routes of one algorithm, differing only in where the A operand (the
normalized input brick) is read from. Where the output tile is 4 x 8 x 8
(tiling 0: every O = 128 conv of the res64 and res128 U-Nets, 28 of a res64
forward's 74 calls and 20 of res128's 64, 92 % of K3's FLOP), the brick is
laid out voxel-major, 16 bytes a voxel a cell of 8 channels, so that eight
output voxels along w are one contiguous core matrix at any tap and an m64
tile one depth plane: wgmma reads A by descriptor and each consumer keeps
two taps in flight. Every other shape keeps the register route: a
row-swizzled brick read into registers by ``ldmatrix``, one tap in flight.
On an H100 (700 W) the descriptor route runs (4, 64^3, 128) -> 128 in 1.45
ms, 65 % of its bound, against the register route's 1.98 ms (47 %); both
give the same bits.

:func:`gn_silu_conv3d` takes its route by the rule of ``ops/_build.py``;
its plain version is :func:`gn_silu_conv3d_reference`, and its declared
backward :class:`._build.PlainBackward` (the counterpart of the JAX
package's ``custom_vjp``, ``meshdiffusion_tpu/ops/gn_silu_conv.py:199-231``):
under autograd the kernel's forward, the plain version's gradients. It
counts its launches in ``gn_silu_conv3d.launches``, and those on the
descriptor route in ``gn_silu_conv3d.descriptor_launches``. The kernel
computes in bfloat16 only.

:func:`gn_silu_conv3d_halo` is the kernel's depth-halo mode, for a rank
that holds one depth slab of the grid (``parallel/spatial.py``): it takes
the whole grid's ``a, b`` (from the statistics' moments mode, merged over
the ranks) in the place of the statistics pass, and a slab of D + lo + hi
planes (its neighbours' boundary planes around it), and writes the slab's
D planes, zero-padded only at the grid's ends. It routes as the one above
and counts its launches in ``gn_silu_conv3d_halo.launches`` (and
``.descriptor_launches``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ..utils import trace
from ._build import PlainBackward, kernel_wrapper
from .groupnorm import _gn_stats, groupnorm_silu_reference
from .roofline import PEAK_BF16_FLOPS, bound_ms

_BK = 64                 # channels a chunk (one 128-byte swizzled row of bf16)
_STAGES = 4              # weight ring stages
SMEM_LIMIT = 232_448     # shared memory a block may use on an H100
_MAX_BRICK = 768         # brick voxels: 64 a brick-building thread (a 64-bit mask)
# tiling -> (output voxels a block, channels a block, tile H, tile W targets)
_TILINGS = {0: (256, 128, 8, 8), 1: (128, 256, 4, 8), 2: (64, 256, 4, 4)}


def conv3d_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME, stride-1 k^3 conv of channels-last x (B, D, H, W, C) with a
    (k, k, k, C, O) kernel, through ``F.conv3d`` on the NCDHW view (a
    channels_last_3d tensor, which cuDNN takes without a copy)."""
    k = kernel.shape[0]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), kernel.permute(4, 3, 0, 1, 2), padding=k // 2)
    return y.permute(0, 2, 3, 4, 1)


def gn_silu_conv3d_reference(x, scale, bias, kernel, conv_bias, num_groups: int = 32,
                             eps: float = 1e-6, dtype=torch.bfloat16,
                             packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version (JAX oracle ``gn_silu_conv3d_reference``):
    GroupNorm (fp32 statistics) -> SiLU -> SAME 3^3 conv in ``dtype`` ->
    + bias in ``dtype``. x (B, D, H, W, C); kernel (3, 3, 3, C, O).
    ``packed``, the kernel's own layout of ``kernel``, is not read."""
    h = groupnorm_silu_reference(x, scale, bias, num_groups, eps)
    return conv3d_same(h.to(dtype), kernel.to(dtype)) + conv_bias.to(dtype)


def conv3d_depth_valid(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Stride-1 k^3 conv of channels-last x with a (k, k, k, C, O) kernel,
    SAME in H and W and VALID in D: x holds the k // 2 planes of depth
    padding (or halo) on each side already."""
    p = kernel.shape[0] // 2
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), kernel.permute(4, 3, 0, 1, 2), padding=(0, p, p))
    return y.permute(0, 2, 3, 4, 1)


def gn_silu_conv3d_halo_reference(x_h, a, b, kernel, conv_bias, halo: Tuple[int, int],
                                  dtype=torch.bfloat16, packed: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Plain version of the depth-halo mode: ``silu(x_h * a + b)`` in fp32
    with the whole grid's per-(B, C) affine, in ``dtype``, zero-padded in D
    by (1 - lo, 1 - hi) (zeros only where the slab meets the grid's ends),
    then the 3^3 conv, VALID in D and SAME in H and W, + bias in ``dtype``.
    x_h (B, D + lo + hi, H, W, C); output (B, D, H, W, O). ``packed`` is
    not read."""
    lo, hi = halo
    h = F.silu(x_h.float() * a[:, None, None, None, :] + b[:, None, None, None, :])
    h = F.pad(h.to(dtype), (0, 0, 0, 0, 0, 0, 1 - lo, 1 - hi))
    return conv3d_depth_valid(h, kernel.to(dtype)) + conv_bias.to(dtype)


def gn_silu_conv3d_cost(x_shape, x_dtype: torch.dtype, out_ch: int,
                        halo: Tuple[int, int] = (0, 0)) -> Tuple[float, float]:
    """(FLOP, bytes) of one call (in the depth-halo mode, x_shape's D holds
    the halo's planes too): 2 * M * 27 * C * O over the M output voxels on
    the bf16 tensor cores; x, the bf16 weights, the bf16 output, the fp32
    affine and bias each moved once."""
    B, D, H, W, C = x_shape
    M = B * (D - sum(halo)) * H * W
    esize = torch.empty((), dtype=x_dtype).element_size()
    nbytes = (B * D * H * W * C * esize + 27 * C * out_ch * 2 + M * out_ch * 2
              + 2 * B * C * 4 + out_ch * 4)
    return 2.0 * M * 27 * C * out_ch, float(nbytes)


def gn_silu_conv3d_bound_ms(x_shape, x_dtype: torch.dtype, out_ch: int,
                            halo: Tuple[int, int] = (0, 0)) -> Tuple[float, str]:
    return bound_ms(*gn_silu_conv3d_cost(x_shape, x_dtype, out_ch, halo), PEAK_BF16_FLOPS)


def block_n(out_ch: int) -> int:
    """Output channels a block: 256 where O allows it, else 128."""
    return 256 if out_ch % 256 == 0 else 128


def smem_bytes(bn: int, td: int, th: int, tw: int, route: int = 0) -> int:
    """Dynamic shared memory of a block: 1024-byte alignment slack, the
    weight ring, two bricks, the mbarriers (the kernel's own sum). The
    descriptor route's brick holds an odd number of voxels a cell."""
    vox = (td + 2) * (th + 2) * (tw + 2)
    if route == 1:
        vox |= 1
    return 1024 + _STAGES * bn * 128 + 2 * vox * 128 + (2 * _STAGES + 4) * 8


@dataclass(frozen=True)
class ConvPlan:
    tiling: int          # 0: 256 voxels x 128 channels, 1: 128 x 256, 2: 64 x 256 (N split)
    route: int           # A operand: 0 ldmatrix into registers, 1 by descriptor from the brick
    TD: int              # output tile
    TH: int
    TW: int
    tiles: int           # output tiles, over every sample
    NB: int              # output-channel blocks
    KS: int              # k-steps: 27 taps x 64-channel chunks
    splits: int          # contiguous k-step ranges (split-K)
    per: int             # k-steps a range (the kernel's ceil(KS / splits))
    items: int           # work items = tiles * NB * splits
    grid: int            # persistent blocks, one an SM at most
    smem: int            # dynamic shared memory a block


@functools.lru_cache(maxsize=None)
def _plan(B: int, D: int, H: int, W: int, C: int, O: int,
          sms: int = _build.H100_SMS) -> ConvPlan:
    """The kernel's launch plan for x (B, D, H, W, C) -> O channels: the
    tiling (by O and the volume), the output tile (D shrunk until two
    bricks and the weight ring fit in shared memory), the route of the A
    operand (by descriptor where the tile is 4 x 8 x 8 of tiling 0, so an
    m64 tile is one depth plane of 8 h-rows of 8 voxels; from registers
    elsewhere), and the split of the 27 x ceil(C/64) k-steps when the
    output tiles alone cannot fill the card (then about one item an SM, no
    range empty). Raises on shapes the kernel does not take."""
    trace.count('rebuild.plan')
    if C % 32 or O % 8 or min(B, D, H, W, C, O) < 1:
        raise ValueError(f'the conv kernel needs C % 32 == 0 and O % 8 == 0, got C={C}, O={O}')
    bn = block_n(O)
    tiling = 0 if bn == 128 else (2 if D * H * W <= 64 else 1)
    bm, bn_t, th, tw = _TILINGS[tiling]
    TW, TH = min(W, tw), min(H, th)
    TD = min(D, bm // (TH * TW))
    brick = lambda td: (td + 2) * (TH + 2) * (TW + 2)
    while TD > 1 and (smem_bytes(bn, TD, TH, TW) > SMEM_LIMIT or brick(TD) > _MAX_BRICK):
        TD -= 1
    route = int(tiling == 0 and (TD, TH, TW) == (4, 8, 8))
    smem = smem_bytes(bn, TD, TH, TW, route)
    if smem > SMEM_LIMIT or brick(TD) > _MAX_BRICK:
        raise ValueError(f'no output tile of ({D}, {H}, {W}) fits in shared memory')
    tiles = B * -(-D // TD) * -(-H // TH) * -(-W // TW)
    NB, KS = -(-O // bn), 27 * -(-C // _BK)
    base = tiles * NB
    want = 1 if base >= sms * 3 // 4 else max(1, sms // base)
    splits = -(-KS // -(-KS // want))
    per = -(-KS // splits)
    items = base * splits
    return ConvPlan(tiling, route, TD, TH, TW, tiles, NB, KS, splits, per, items, min(items, sms),
                    smem)


def packed_numel(C: int, O: int) -> int:
    return -(-O // block_n(O)) * block_n(O) * 27 * -(-C // _BK) * _BK


def pack_conv_weights(kernel: torch.Tensor) -> torch.Tensor:
    """The (3, 3, 3, C, O) kernel as the conv kernel's B tiles, flat bf16:
    (N block, 64-channel chunk, tap, BN output channels, 64 input channels),
    zero-padded to whole chunks and blocks, each tile K-major with its
    16-byte chunks XOR-swizzled by the row (the image a wgmma descriptor
    with 128-byte swizzle reads): element (n, k) of a tile sits at
    n * 64 + ((k // 8) ^ (n % 8)) * 8 + k % 8."""
    C, O = kernel.shape[3], kernel.shape[4]
    bn = block_n(O)
    CK, NB = -(-C // _BK), -(-O // bn)
    w = kernel.detach().reshape(27, C, O)       # a view for a contiguous or a permuted Conv3d weight
    if CK * _BK != C or NB * bn != O:
        w = F.pad(w, (0, NB * bn - O, 0, CK * _BK - C))
    w = w.reshape(27, CK, _BK, NB, bn).permute(3, 1, 0, 4, 2)       # (NB, CK, 27, n, k)
    w = w.unflatten(4, (8, 8)).unflatten(3, (bn // 8, 8))            # n = (n8, r), k = (chunk, e)
    r = torch.arange(8)
    w = w[..., r[:, None], r[None, :] ^ r[:, None], :]               # chunk p holds chunk p ^ r
    return w.to(torch.bfloat16).reshape(-1)


_partials = {}    # (device, stream) -> fp32 split-K scratch, grown on demand and reused


def _scratch(device, stream: int, numel: int) -> torch.Tensor:
    """Calls on one stream run in order and share a scratch; another stream
    gets its own."""
    buf = _partials.get((device, stream))
    if buf is None or buf.numel() < numel:
        trace.count('rebuild.scratch')
        buf = _partials[(device, stream)] = torch.empty(numel, device=device, dtype=torch.float32)
    return buf


@kernel_wrapper(gn_silu_conv3d_reference, PlainBackward)
def gn_silu_conv3d(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   kernel: torch.Tensor, conv_bias: torch.Tensor, num_groups: int = 32,
                   eps: float = 1e-6, dtype=torch.bfloat16,
                   packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm -> SiLU -> SAME 3^3 conv + bias. x (B, D, H, W, C) in fp32
    or bf16; kernel (3, 3, 3, C, O); output (B, D, H, W, O) in ``dtype``.
    ``packed``: the kernel as :func:`pack_conv_weights` lays it out (the
    U-Net's convs keep it between calls); packed here when not given."""
    B, D, H, W, C = x.shape
    O = kernel.shape[-1]
    if dtype != torch.bfloat16:
        raise ValueError(f'the conv kernel computes in bfloat16, not {dtype}')
    if kernel.shape != (3, 3, 3, C, O):
        raise ValueError(f'kernel {tuple(kernel.shape)} is not (3, 3, 3, {C}, O)')
    if C % num_groups:
        raise ValueError(f'channels {C} not divisible by {num_groups} groups')
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError('x must be contiguous float32 or bfloat16')
    plan = _plan(B, D, H, W, C, O, _build.sm_count(x.device.index or 0))
    packed = _check_packed(packed, kernel, C, O)
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError('x and the packed weights must be 16-byte aligned')
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        # the statistics; an fp32 x also comes back rounded to bf16, the operand
        a, b, xb = _gn_stats(x, scale, bias, num_groups, eps, stream,
                             round_bf16=x.dtype == torch.float32)
        out = _launch(x if xb is None else xb, a, b, packed, conv_bias, plan, D, O, (0, 0),
                      stream, 'gn_silu_conv3d')
    gn_silu_conv3d.launches += 1
    gn_silu_conv3d.descriptor_launches += plan.route
    return out


gn_silu_conv3d.descriptor_launches = 0     # of its launches, those on the descriptor route


def _launch(xb, a, b, packed, conv_bias, plan: ConvPlan, D: int, O: int,
            halo: Tuple[int, int], stream: int, what: str) -> torch.Tensor:
    """One launch of ``csrc/gn_silu_conv3d.cu`` on ``stream`` (x's device
    current): bf16 xb (B, D + lo + hi, H, W, C) -> (B, D, H, W, O) bf16."""
    B, _, H, W, C = xb.shape
    cb = conv_bias.float().contiguous()
    out = torch.empty((B, D, H, W, O), device=xb.device, dtype=torch.bfloat16)
    partial = (_scratch(xb.device, stream, plan.splits * B * D * H * W * O)
               if plan.splits > 1 else None)
    err = _build.lib().gn_silu_conv3d_bf16(
        xb.data_ptr(), a.data_ptr(), b.data_ptr(), packed.data_ptr(), cb.data_ptr(),
        out.data_ptr(), partial.data_ptr() if partial is not None else None,
        B, D, H, W, C, O, plan.tiling, plan.route, plan.TD, plan.TH, plan.TW, plan.splits,
        plan.grid, halo[0], halo[1], stream)
    _build.check(err, what)
    return out


def _check_packed(packed: Optional[torch.Tensor], kernel: torch.Tensor, C: int, O: int
                  ) -> torch.Tensor:
    if packed is None:
        return pack_conv_weights(kernel)
    if (packed.dtype != torch.bfloat16 or packed.numel() != packed_numel(C, O)
            or not packed.is_contiguous()):
        raise ValueError('packed is not pack_conv_weights(kernel)')
    return packed


@kernel_wrapper(gn_silu_conv3d_halo_reference, PlainBackward)
def gn_silu_conv3d_halo(x_h: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        kernel: torch.Tensor, conv_bias: torch.Tensor, halo: Tuple[int, int],
                        dtype=torch.bfloat16, packed: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The depth-halo mode: ``silu(x_h * a + b)`` then the 3^3 conv + bias
    over a depth slab. x_h (B, D + lo + hi, H, W, C) in fp32 or bf16 (cast
    once to bf16, the operand), its lo / hi (each 0 or 1) planes before and
    after the slab's D taken from the neighbouring slabs (0 where the slab
    meets the grid's end); a, b (B, C) fp32, the whole grid's affine; kernel
    (3, 3, 3, C, O); output (B, D, H, W, O) in ``dtype``."""
    lo, hi = halo
    B, Dh, H, W, C = x_h.shape
    O, D = kernel.shape[-1], Dh - lo - hi
    if dtype != torch.bfloat16:
        raise ValueError(f'the conv kernel computes in bfloat16, not {dtype}')
    if lo not in (0, 1) or hi not in (0, 1) or D < 1:
        raise ValueError(f'halo {halo} on {Dh} planes: lo and hi must be 0 or 1, D >= 1')
    if kernel.shape != (3, 3, 3, C, O):
        raise ValueError(f'kernel {tuple(kernel.shape)} is not (3, 3, 3, {C}, O)')
    if a.shape != (B, C) or b.shape != (B, C) or a.dtype != torch.float32 \
            or b.dtype != torch.float32 or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f'a and b must be contiguous fp32 ({B}, {C})')
    if x_h.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError('x_h must be float32 or bfloat16')
    plan = _plan(B, D, H, W, C, O, _build.sm_count(x_h.device.index or 0))
    packed = _check_packed(packed, kernel, C, O)
    xb = x_h.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError('x and the packed weights must be 16-byte aligned')
    with torch.cuda.device(x_h.device):
        out = _launch(xb, a, b, packed, conv_bias, plan, D, O, (lo, hi),
                      torch.cuda.current_stream().cuda_stream, 'gn_silu_conv3d_halo')
    gn_silu_conv3d_halo.launches += 1
    gn_silu_conv3d_halo.descriptor_launches += plan.route
    return out


gn_silu_conv3d_halo.descriptor_launches = 0
