"""The DiT and FLUX blocks' multi-head attention in one pass, forward only.

    out[b, t, h dh + n] = sum_s softmax_s(q_t . k_s / sqrt(dh)) v_s[n]

per sample b and head h, with q, k and v read in place from a (B, T, 3 D)
buffer (DiT's split: (3, H, dh) along the last axis): the DiT's qkv
Linear's output, or the joint sequence of a FLUX block that
:func:`.qk_norm_rope` writes; the heads' outputs side by side in (B, T,
D), ready for the output projections. No TPU kernel corresponds: the JAX
package has no transformer; the U-Net's attention
(``meshdiffusion_tpu/models/layers.py::AttnBlock``) is a single-head pair
of einsums with the scores in memory, which at the DiT's 4096 tokens, 16
heads and 28 blocks would move ~15 GB a block at batch 4.

What bounds it on the H100: the tensor cores. 4 B H T^2 dh FLOP (two
products of 2 T^2 dh a head) against 8 B T D bytes (qkv read once, the
output written once): at T 4096, dh 72, ~2,300 operations a byte against
the card's ~295 at its ridge. The T x T scores never reach device memory.

Design (CUDA C++, sm_90a, ``csrc/dit_attention.cu``): besides the tensor
cores, the softmax's exponentials bound it (one ex2 a score at 16 a clock
against ~304 tensor FLOP a score at dh 72), so loads and softmax have to
run under the products. One persistent block an SM walks (sample, head,
query tile) items in a fixed stride, the query tile fastest; the grid is
min(items, SMs), from the call's B, T, H and the card alone. A producer
warp brings Q once an item (two buffers) and K and V in tiles of 64 keys
(a ring of stages, full and empty mbarriers for K and for V) by TMA from
tensor maps over qkv in place; consumer warpgroups of 64 queries take
turns on named barriers to issue their products, S_j = Q K_j^T (wgmma
m64n64k16, Q and K from shared memory) together with O += P_{j-1} V_{j-1}
(m64n{dh}k16, P from registers), and run S_j's online softmax (fp32, exp2
with the scale folded in) while P_{j-1} V_{j-1} runs. O is divided by the
row sums at the end and stored as bf16. Each block's sums are its own:
reruns agree bit for bit. One body, two instantiations:

* dh 72 (``dit_attention_kernel``): three consumer warpgroups, 192-query
  items, depth 80 (dh 72 zero-padded to wgmma's k step of 16), a 5-stage
  ring;
* dh 128 (``dit_attention_dh128_kernel``): the accumulator O is 64 fp32
  registers a thread, so two consumer warpgroups of 240 registers,
  128-query items, no padding, a 4-stage ring.

K and V are read once for each item's queries
(:func:`dit_attention_kv_bytes`).

The wrapper takes its route by the rule of ``ops/_build.py`` and declares
no backward; its plain version is :func:`dit_attention_reference`. The
kernel runs once a call; the wrapper counts its launches in
``dit_attention.launches``. The kernel takes the head dimensions of
:data:`HEAD_DIMS` alone.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ._build import kernel_wrapper

HEAD_DIMS = (72, 128)   # the head dimensions the kernel is built for
BLOCK_QUERIES = {72: 192, 128: 128}     # queries a work item of the kernel, by head dimension


def dit_attention_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version: per head, softmax(q k^T dh^-1/2) v in fp32 from
    qkv's values; the result in qkv's dtype, (B, T, D)."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    q, k, v = qkv.float().reshape(B, T, 3, num_heads, D // num_heads).permute(2, 0, 3, 1, 4)
    w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * (D // num_heads) ** -0.5, dim=-1)
    return torch.matmul(w, v).transpose(1, 2).reshape(B, T, D).to(qkv.dtype)


def dit_attention_cost(B: int, T: int, num_heads: int, head_dim: int) -> Tuple[float, float]:
    """(FLOP, bytes) of one call: 4 B H T^2 dh products on the bf16 tensor
    cores (with the real dh, not the padded depth); the bf16 qkv read once
    and the bf16 output written once, 4 B T D 2 bytes."""
    D = num_heads * head_dim
    return 4.0 * B * num_heads * T * T * head_dim, 4.0 * B * T * D * 2


def dit_attention_kv_bytes(B: int, T: int, num_heads: int, head_dim: int) -> float:
    """Bytes of K and V the kernel reads from L2 into shared memory in one
    call: each (sample, head, query tile) item reads its head's K and V
    whole, in bf16."""
    tiles = -(-T // BLOCK_QUERIES[head_dim])
    return float(B * num_heads * tiles) * T * 2 * head_dim * 2


@kernel_wrapper(dit_attention_reference)
def dit_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Multi-head attention of a (B, T, 3 D) q, k, v buffer with
    ``num_heads`` heads; returns (B, T, D). On CUDA tensors qkv is a
    contiguous, 16-byte aligned bf16 tensor, D / num_heads is in
    :data:`HEAD_DIMS`."""
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f'dit_attention: qkv {tuple(qkv.shape)} is no (B, T, 3 D) '
                         f'of {num_heads} heads')
    B, T, D3 = qkv.shape
    dh = D3 // (3 * num_heads)
    if dh not in HEAD_DIMS:
        raise ValueError(f'dit_attention: head dimension {dh}; the kernel takes {HEAD_DIMS}')
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError('dit_attention: takes a contiguous, 16-byte aligned bf16 qkv')
    if B * T == 0:
        raise ValueError('dit_attention: takes at least one token')
    out = torch.empty((B, T, D3 // 3), dtype=torch.bfloat16, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _build.lib().dit_attention_bf16(
            qkv.data_ptr(), out.data_ptr(), B, T, num_heads, dh,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, 'dit_attention')
    dit_attention.launches += 1
    return out
