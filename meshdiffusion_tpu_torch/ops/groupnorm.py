"""GroupNorm(32) statistics and fused GroupNorm + SiLU, channels-last.

Replaces the TPU kernel ``meshdiffusion_tpu/ops/groupnorm.py``
(``fused_groupnorm_silu``, pallas_call at :114) with two kernels:

* ``gn_stats`` (:func:`gn_affine`, CUDA C++ ``csrc/gn_stats.cu``, one
  launch): per-(sample, group) fp32 statistics, folded with the GroupNorm
  scale and bias into a per-(sample, channel) affine ``a, b`` such that
  ``GroupNorm(x) = x * a + b``. The same fold (``_gn_affine`` in
  ``meshdiffusion_tpu/ops/gn_silu_conv.py:62``) feeds the conv kernel of
  ``gn_silu_conv.py``, 75 times a res64 forward.
* ``groupnorm_silu_apply`` (:func:`groupnorm_silu`, Triton): ``silu(x * a + b)``.
* the statistics kernel's moments mode (:func:`gn_moments`): each (sample,
  group)'s fp32 (mean, M2) over a rank's depth slab, for the spatially
  sharded U-Net (``parallel/spatial.py``): the slabs' moments are gathered,
  merged in rank order (:func:`merge_moments`, Chan's formula) and folded
  (:func:`affine_from_moments`, shared with the plain route) into the whole
  grid's ``a, b``. Under autograd it keeps a backward of its own, exact
  (:class:`_GnMoments`).

What bounds them on the H100: both are memory-bound (the statistics read x
once, the apply reads it again and writes the output); below 32^3 the
statistics read less than a launch costs. The Pallas kernel walks row
blocks in order and carries its sums from one grid step to the next; Hopper
blocks run in no order, so the statistics kernel merges per-block Welford
triples with Chan's formula, the last block to finish doing the final merge
in a fixed order (see the note in ``csrc/gn_stats.cu``). Triton fits the
apply: one elementwise pass.

Every wrapper takes its route by the rule of ``ops/_build.py``. Its plain
PyTorch version (``*_reference``) is the spec, mirroring the JAX oracles.
Only :func:`gn_moments` declares a backward. Each wrapper counts its
launches in ``.launches``.
"""

from __future__ import annotations  # kernel annotations stay strings until Triton reads them

import functools
import math
from types import SimpleNamespace
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build
from ..utils import trace
from ._build import kernel_wrapper

# Bound at the first launch by _kernels(); the kernel bodies below read them
# as module globals, so importing this module needs no Triton.
triton = tl = None


def _groupnorm_f32(x, scale, bias, num_groups, eps) -> torch.Tensor:
    """Channels-last GroupNorm with scale and bias, fp32 statistics and result."""
    B, C = x.shape[0], x.shape[-1]
    xf = x.float().reshape(B, -1, num_groups, C // num_groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    h = (xf - mean) * torch.rsqrt(var + eps)
    return (h.reshape(B, -1, C) * scale.float() + bias.float()).reshape(x.shape)


def groupnorm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """Channels-last GroupNorm with fp32 statistics; output in x's dtype."""
    return _groupnorm_f32(x, scale, bias, num_groups, eps).to(x.dtype)


def groupnorm_silu_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                             num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """Channels-last GroupNorm + SiLU with fp32 statistics; output in x's
    dtype (JAX oracle ``groupnorm_silu_reference``)."""
    return F.silu(_groupnorm_f32(x, scale, bias, num_groups, eps)).to(x.dtype)


def gn_affine_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        num_groups: int = 32, eps: float = 1e-6
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm + scale/bias folded into per-(B, C) fp32 ``a, b``
    (``_gn_affine`` of the JAX package)."""
    B, C = x.shape[0], x.shape[-1]
    xf = x.float().reshape(B, -1, num_groups, C // num_groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), correction=0)      # (B, g)
    inv_c = torch.rsqrt(var + eps).repeat_interleave(C // num_groups, dim=1)
    mean_c = mean.repeat_interleave(C // num_groups, dim=1)
    a = inv_c * scale.float()[None]
    return a, bias.float()[None] - mean_c * a


def gn_moments_reference(x: torch.Tensor, num_groups: int = 32) -> torch.Tensor:
    """(B, G, 2) fp32: the mean and M2 (the sum of squared deviations from
    the mean) of each (sample, group) of channels-last x."""
    B, C = x.shape[0], x.shape[-1]
    xf = x.float().reshape(B, -1, num_groups, C // num_groups)
    mean = xf.mean(dim=(1, 3))
    m2 = torch.square(xf - mean[:, None, :, None]).sum(dim=(1, 3))
    return torch.stack([mean, m2], dim=-1)


def merge_moments(moments: torch.Tensor, count: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Merge S slabs' moments (S, B, G, 2), each over ``count`` elements of a
    (sample, group), in slab order with Chan's formula: (mean, M2) (B, G) of
    the whole and its element count. Plain torch, differentiable, the same
    order on every rank."""
    n, mean, m2 = float(count), moments[0, ..., 0], moments[0, ..., 1]
    for s in range(1, moments.shape[0]):
        t = n + count
        d = moments[s, ..., 0] - mean
        mean = mean + d * (count / t)
        m2 = m2 + moments[s, ..., 1] + d * d * (n * count / t)
        n = t
    return mean, m2, n


def affine_from_moments(mean: torch.Tensor, m2: torch.Tensor, count: float,
                        scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a (sample, group)'s mean and M2 over ``count`` elements with the
    GroupNorm scale and bias into per-(B, C) fp32 ``a, b`` (as
    :func:`gn_affine_reference` folds them)."""
    gw = scale.shape[0] // mean.shape[1]
    inv_c = torch.rsqrt(m2 / count + eps).repeat_interleave(gw, dim=1)
    a = inv_c * scale.float()[None]
    return a, bias.float()[None] - mean.repeat_interleave(gw, dim=1) * a


def gn_affine_cost(x_shape, x_dtype: torch.dtype) -> Tuple[float, float]:
    """(FLOP, bytes) of one call: 3 fp32 operations an element (a running
    sum and sum of squares); x read once, fp32 a and b written once."""
    n, B, C = math.prod(x_shape), x_shape[0], x_shape[-1]
    esize = torch.empty((), dtype=x_dtype).element_size()
    return 3.0 * n, float(n * esize + 2 * B * C * 4 + 2 * C * 4)


def groupnorm_silu_cost(x_shape, x_dtype: torch.dtype) -> Tuple[float, float]:
    """(FLOP, bytes) of one call (statistics and apply): 8 fp32 operations
    an element; x read once and the output written once, in x's dtype."""
    n = math.prod(x_shape)
    esize = torch.empty((), dtype=x_dtype).element_size()
    return 8.0 * n, float(2 * n * esize + 2 * x_shape[-1] * 4)


# ---------------------------------------------------------------------------
# Triton kernels (compiled on the card at first launch)
# ---------------------------------------------------------------------------

# out = silu(x * a[b, c] + b[b, c]) over the flat channels-last tensor; SC = S*C.
def _gn_silu_apply_kernel(x_ptr, a_ptr, b_ptr, out_ptr, N, SC, C, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < N
    x = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
    ab = (offs // SC) * C + offs % C
    h = x * tl.load(a_ptr + ab, mask=m, other=0.0) + tl.load(b_ptr + ab, mask=m, other=0.0)
    tl.store(out_ptr + offs, (h * tl.sigmoid(h)).to(out_ptr.dtype.element_ty), mask=m)


@functools.cache
def _kernels() -> SimpleNamespace:
    global triton, tl
    import triton
    import triton.language as tl
    _build.watch_triton_compiles()
    return SimpleNamespace(apply=triton.jit(_gn_silu_apply_kernel))


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_STATS_THREADS = 256     # csrc/gn_stats.cu THREADS
_MAX_BLOCKS = 256        # row blocks a sample: the last block merges this many
_IN_BLOCK = 32 << 10     # bytes of a (sample, channel chunk) that one block reads and merges


@functools.lru_cache(maxsize=None)
def _gn_plan(S: int, C: int, num_groups: int, esize: int,
             sms: int = _build.H100_SMS) -> Tuple[int, int]:
    """The statistics kernel's block: CC channels (the largest multiple of 8
    and of the group width that divides C, at most 256) by R rows (about
    1/(2 * sms) of the input, two blocks an SM; 16-64 KB a block, at most
    256 blocks a sample, a multiple of the rows a block reads in parallel).
    Up to 32 KB a channel chunk, R >= S: one block covers every row of its
    channels and merges in the block."""
    trace.count('rebuild.plan')
    gw = C // num_groups
    cands = [cc for cc in range(8, min(C, 256) + 1, 8) if C % cc == 0 and cc % gw == 0]
    if C % 8 or not cands:
        raise ValueError(f'the statistics kernel needs C % 8 == 0 and a group width dividing '
                         f'a multiple of 8 up to 256; got C={C}, {num_groups} groups')
    CC = cands[-1]
    rp = _STATS_THREADS // (CC // 8)
    if S * CC * esize <= _IN_BLOCK:
        return CC, -(-S // rp) * rp
    target = min(max(S * C * esize // (2 * sms), 16 << 10), 64 << 10)
    R = max(rp, -(-target // (CC * esize * rp)) * rp, -(-S // (_MAX_BLOCKS * rp)) * rp)
    return CC, R


_scratch = {}      # (device, stream) -> (workspace, ticket)


def _stats_scratch(device, stream: int, numel: int):
    """The merge's workspace and ticket. Calls on one stream run in order and
    share them (the last block leaves the ticket at 0); another stream gets
    its own."""
    work, ticket = _scratch.get((device, stream), (None, None))
    if work is None or work.numel() < numel:
        trace.count('rebuild.scratch')
        work = torch.empty(max(numel, 1 << 16), device=device, dtype=torch.float32)
        if ticket is None:
            ticket = torch.zeros(1, device=device, dtype=torch.int32)
        _scratch[(device, stream)] = (work, ticket)
    return work, ticket


def _check(x: torch.Tensor, scale, bias, num_groups: int):
    C = x.shape[-1]
    if C % num_groups:
        raise ValueError(f'channels {C} not divisible by {num_groups} groups')
    if not x.is_contiguous():
        raise ValueError('x must be contiguous channels-last (B, ..., C)')
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f'unsupported dtype {x.dtype}')
    if scale is not None and (scale.shape != (C,) or bias.shape != (C,)):
        raise ValueError(f'scale/bias must have shape ({C},)')


def _stats_launch(x: torch.Tensor, num_groups: int, stream: int, outs, scale=None, bias=None,
                  eps: float = 0.0, xb=None, moments=None) -> None:
    """One launch of ``csrc/gn_stats.cu`` on ``stream`` (x's device current),
    writing ``outs`` (a, b) from the fp32 contiguous ``scale`` and ``bias``
    or, in moments mode, ``moments``."""
    _check(x, scale, bias, num_groups)
    B, C = x.shape[0], x.shape[-1]
    S = x.numel() // (B * C)
    CC, R = _gn_plan(S, C, num_groups, x.element_size(), _build.sm_count(x.device.index or 0))
    if x.data_ptr() % 16:
        raise ValueError('x must be 16-byte aligned')
    work, ticket = _stats_scratch(x.device, stream, B * -(-S // R) * num_groups * 2)
    ptr = lambda t: t.data_ptr() if t is not None else None
    a, b = outs if outs is not None else (None, None)
    err = _build.lib().gn_stats(
        x.data_ptr(), _DTYPE_CODE[x.dtype], ptr(scale), ptr(bias), ptr(a), ptr(b),
        work.data_ptr(), ticket.data_ptr(), ptr(xb), ptr(moments), B, S, C, num_groups, CC, R,
        float(eps), stream)
    _build.check(err, 'gn_moments' if moments is not None else 'gn_affine')


def _gn_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int,
              eps: float, stream: int, round_bf16: bool = False):
    """One launch of ``csrc/gn_stats.cu`` on ``stream`` (x's device current):
    fp32 ``a, b`` (B, C), and with ``round_bf16`` (fp32 x only) x rounded to
    bf16 as well, else None."""
    if round_bf16 and x.dtype != torch.float32:
        raise ValueError('only an fp32 x is rounded to bf16')
    B, C = x.shape[0], x.shape[-1]
    a, b = torch.empty((2, B, C), device=x.device, dtype=torch.float32)
    xb = torch.empty(x.shape, device=x.device, dtype=torch.bfloat16) if round_bf16 else None
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    _stats_launch(x, num_groups, stream, (a, b), scale, bias, eps, xb=xb)
    gn_affine.launches += 1
    return a, b, xb


@kernel_wrapper(gn_affine_reference)
def gn_affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              num_groups: int = 32, eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, C) fp32 ``a, b`` with ``GroupNorm(x) = x*a + b``; x is
    channels-last (B, ..., C) in any float dtype. One launch of
    ``csrc/gn_stats.cu`` on CUDA, with a scratch workspace and ticket of
    the current stream's own."""
    with torch.cuda.device(x.device):
        a, b, _ = _gn_stats(x, scale, bias, num_groups, eps, torch.cuda.current_stream().cuda_stream)
    return a, b


class _GnMoments(torch.autograd.Function):
    """:func:`gn_moments` forward; the exact gradient backward: d mean / dx
    = 1 / n and d M2 / dx = 2 (x - mean) over each (sample, group)."""

    @staticmethod
    def forward(ctx, forward, reference, x, num_groups):
        m = forward(x, num_groups)
        ctx.save_for_backward(x, m)
        ctx.num_groups = num_groups
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        G = ctx.num_groups
        B, C = x.shape[0], x.shape[-1]
        xf = x.float().reshape(B, -1, G, C // G)
        n = xf.shape[1] * xf.shape[3]
        gx = (g[:, None, :, None, 0] / n
              + 2.0 * g[:, None, :, None, 1] * (xf - m[:, None, :, None, 0]))
        return None, None, gx.reshape(x.shape).to(x.dtype), None


@kernel_wrapper(gn_moments_reference, _GnMoments)
def gn_moments(x: torch.Tensor, num_groups: int = 32) -> torch.Tensor:
    """(B, G, 2) fp32 (mean, M2) of each (sample, group) of channels-last x:
    the statistics kernel in its moments mode, one launch, on CUDA."""
    out = torch.empty((x.shape[0], num_groups, 2), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _stats_launch(x, num_groups, torch.cuda.current_stream().cuda_stream, None, moments=out)
    gn_moments.launches += 1
    return out


def gn_moments_cost(x_shape, x_dtype: torch.dtype, num_groups: int = 32) -> Tuple[float, float]:
    """(FLOP, bytes) of one :func:`gn_moments` call: 3 fp32 operations an
    element; x read once, the (B, G, 2) fp32 moments written once."""
    n, B = math.prod(x_shape), x_shape[0]
    esize = torch.empty((), dtype=x_dtype).element_size()
    return 3.0 * n, float(n * esize + B * num_groups * 2 * 4)


@kernel_wrapper(groupnorm_silu_reference)
def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm(num_groups) + SiLU over channels-last x; output in x's dtype."""
    a, b = gn_affine(x, scale, bias, num_groups, eps)     # checks x, scale and bias
    out = torch.empty_like(x)
    N = x.numel()
    B, C = x.shape[0], x.shape[-1]
    BLOCK = 1024
    with torch.cuda.device(x.device):
        _kernels().apply[(triton.cdiv(N, BLOCK),)](x, a, b, out, N, N // B, C,
                                                   BLOCK=BLOCK, num_warps=4)
    groupnorm_silu.launches += 1
    return out
