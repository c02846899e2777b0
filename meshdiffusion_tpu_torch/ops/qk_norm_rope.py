"""FLUX's QK normalisation and 3-axis rotary positions in one pass, forward
only: the joint (B, T1 + T2, 3 D) buffer that :func:`.dit_attention` reads.

For each token l of the joint sequence and head h, with q, k, v at (3, H,
dh) of the first 3 D columns of its source row:

    q' = rope(q * rsqrt(mean(q^2) + 1e-6) * q_scale, pe[l])
    k' = rope(k * rsqrt(mean(k^2) + 1e-6) * k_scale, pe[l]),   v' = v

rope turning each adjacent pair (2 i, 2 i + 1) of a head by pe[l, i] =
(cos, sin): out_0 = cos x_0 - sin x_1, out_1 = sin x_0 + cos x_1 (FLUX's
``QKNorm`` and ``math.py::apply_rope``). Rows 0 .. T1 - 1 of the joint
sequence come from ``x`` with its scales, rows T1 .. from ``x2`` with its
own (a double-stream block: the txt and img streams' qkv); without ``x2``
every row comes from ``x`` (a single-stream block: the first 3 D of
``linear1``'s 7 D columns). No TPU kernel corresponds: the JAX package has
no transformer.

What bounds it on the H100: bytes, each row read and written once in bf16
(:func:`qk_norm_rope_cost`: 0.68 GB, 0.203 ms a FLUX-dev b4 call).

Design (CUDA C++, sm_90a, ``csrc/qk_norm_rope.cu``): a block of 256
threads a row, 8 values a thread, 16 threads a head (the mean of squares
by shuffles), all of a row's loads in flight before the arithmetic; RMS,
scale and rotation in fp32, one bf16 rounding of the result. The plain
version (:func:`qk_norm_rope_reference`) computes in fp32 too and rounds
once to the sources' dtype (FLUX rounds to bf16 after the RMS, the scale
and the rotation).

The wrapper takes its route by the rule of ``ops/_build.py`` and declares
no backward. The kernel runs once a call; the wrapper counts its launches
in ``qk_norm_rope.launches``. It takes a head dimension of 128 alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._build import kernel_wrapper

HEAD_DIMS = (128,)       # the head dimensions the kernel is built for
EPS = 1e-6


def _split(src: torch.Tensor, D: int, num_heads: int):
    B, T, _ = src.shape
    return src[..., :3 * D].float().reshape(B, T, 3, num_heads, D // num_heads).unbind(2)


def _rms(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return t * torch.rsqrt(t.pow(2).mean(dim=-1, keepdim=True) + EPS) * scale.float()


def qk_norm_rope_reference(x: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor,
                           pe: torch.Tensor, num_heads: int, x2: Optional[torch.Tensor] = None,
                           q_scale2: Optional[torch.Tensor] = None,
                           k_scale2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version, in fp32: each source's q and k RMS-normalised over a
    head and scaled by its own scales, the joint sequence's q and k turned
    by ``pe`` (T1 + T2, dh / 2, 2), v copied; (B, T1 + T2, 3 D) in x's
    dtype."""
    dh = q_scale.shape[-1]
    D = num_heads * dh
    q, k, v = _split(x, D, num_heads)
    q, k = _rms(q, q_scale), _rms(k, k_scale)
    if x2 is not None:
        q2, k2, v2 = _split(x2, D, num_heads)
        q = torch.cat([q, _rms(q2, q_scale2)], dim=1)
        k = torch.cat([k, _rms(k2, k_scale2)], dim=1)
        v = torch.cat([v, v2], dim=1)
    cos, sin = pe.float()[None, :, None, :, 0], pe.float()[None, :, None, :, 1]

    def rope(t):
        t0, t1 = t.reshape(*t.shape[:-1], dh // 2, 2).unbind(-1)
        return torch.stack([cos * t0 - sin * t1, sin * t0 + cos * t1], dim=-1).flatten(-2)
    B, L = q.shape[:2]
    return torch.stack([rope(q), rope(k), v], dim=2).reshape(B, L, 3 * D).to(x.dtype)


def qk_norm_rope_cost(B: int, T: int, num_heads: int, head_dim: int) -> Tuple[float, float]:
    """(FLOP, bytes) of one call over T joint tokens: ~10 fp32 operations a
    q or k value (square and sum, the scale, the rotation); each bf16 row of
    3 D read once and written once, the rotation table (T, dh / 2, 2) fp32
    read once (the scales' 2 KB left out)."""
    D = num_heads * head_dim
    return 10.0 * B * T * 2 * D, 2.0 * B * T * 3 * D * 2 + T * head_dim * 4


def _check(what, t, fp32=False):
    dtype = torch.float32 if fp32 else torch.bfloat16
    if t.dtype != dtype or t.data_ptr() % 16 or t.stride(-1) != 1:
        raise ValueError(f'qk_norm_rope: {what} must be {dtype} with unit stride along its '
                         f'last axis and 16-byte aligned')


@kernel_wrapper(qk_norm_rope_reference)
def qk_norm_rope(x: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor,
                 pe: torch.Tensor, num_heads: int, x2: Optional[torch.Tensor] = None,
                 q_scale2: Optional[torch.Tensor] = None,
                 k_scale2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The joint (B, T1 + T2, 3 D) q, k, v of ``num_heads`` heads from ``x``
    (B, T1, S1) and, where given, ``x2`` (B, T2, S2), each with q, k, v in
    its first 3 D columns, S1 and S2 at least 3 D; ``q_scale`` and
    ``k_scale`` (dh,) are x's RMSNorm scales, ``q_scale2`` and ``k_scale2``
    x2's; ``pe`` (T1 + T2, dh / 2, 2) the rotation's (cos, sin). On CUDA
    tensors the sources are bf16 with contiguous rows and row strides a
    multiple of 8, the scales and ``pe`` contiguous fp32, dh in
    :data:`HEAD_DIMS`."""
    dh = q_scale.shape[-1]
    D = num_heads * dh
    if dh not in HEAD_DIMS:
        raise ValueError(f'qk_norm_rope: head dimension {dh}; the kernel takes {HEAD_DIMS}')
    srcs = [x] if x2 is None else [x, x2]
    for s in srcs:
        if s.ndim != 3 or s.shape[-1] < 3 * D or s.shape[0] != x.shape[0]:
            raise ValueError(f'qk_norm_rope: source {tuple(s.shape)} holds no (B, T, 3 D) of '
                             f'{num_heads} heads of {dh}')
        if s.stride(1) % 8 or s.stride(0) != s.stride(1) * s.shape[1]:
            raise ValueError('qk_norm_rope: a source needs rows one after another, their '
                             'stride a multiple of 8')
        _check('a source', s)
    scales = [q_scale, k_scale] if x2 is None else [q_scale, k_scale, q_scale2, k_scale2]
    for s in scales:
        if s is None or s.shape != (dh,) or not s.is_contiguous():
            raise ValueError('qk_norm_rope: each source takes two contiguous (dh,) scales')
        _check('a scale', s, fp32=True)
    B, T1 = x.shape[:2]
    T2 = 0 if x2 is None else x2.shape[1]
    if pe.shape != (T1 + T2, dh // 2, 2) or not pe.is_contiguous():
        raise ValueError(f'qk_norm_rope: pe {tuple(pe.shape)}; expected ({T1 + T2}, {dh // 2}, 2)')
    _check('pe', pe, fp32=True)
    if B * T1 == 0:
        raise ValueError('qk_norm_rope: takes at least one token')
    out = torch.empty((B, T1 + T2, 3 * D), dtype=torch.bfloat16, device=x.device)
    second = (x2.data_ptr(), T2, x2.stride(1), q_scale2.data_ptr(), k_scale2.data_ptr()) \
        if x2 is not None else (None, 0, 0, None, None)
    with torch.cuda.device(x.device):
        err = _build.lib().qk_norm_rope_bf16(
            x.data_ptr(), T1, x.stride(1), second[0], second[1], second[2],
            q_scale.data_ptr(), k_scale.data_ptr(), second[3], second[4], pe.data_ptr(),
            out.data_ptr(), B, num_heads, dh, torch.cuda.current_stream().cuda_stream)
    _build.check(err, 'qk_norm_rope')
    qk_norm_rope.launches += 1
    return out
