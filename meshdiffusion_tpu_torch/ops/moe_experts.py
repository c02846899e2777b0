"""The routed experts of a sparse-expert FFN as two grouped products.

    H[r]      = SiLU(x[tok(r)] Wg[e(r)]^T) * (x[tok(r)] Wu[e(r)]^T)     (F,)
    out[d]    = p[d] * H[r] Wd[e(r)]^T                                 (D,)

over the routed (token, slot) pairs of a sparse-expert FFN (DiT-MoE's
``SparseMoeBlock``, ``models/moe.py``): ``order`` lists the pairs, each as
``token * k + slot``, sorted by expert (the permuted rows r), expert e owns
rows ``offsets[e]:offsets[e + 1]``, tok(r) = order[r] // k, d = order[r],
and p the pair's routing weight. The result is each pair's weighted expert
output in pair order, (N k, D) fp32; the caller sums a token's k slots. No
TPU kernel corresponds: the JAX package has no transformer and no routed
layer. cuBLAS has no product over a partition of rows held on the device:
a loop of one product an expert (the plain version) needs the partition on
the host, a synchronisation a layer.

What bounds it on the H100: the tensor cores. A pair's row costs 6 D F
FLOP (2 D 2F for gate and up, 2 F D for down): 31.9 MFLOP at DiT-MoE-XL's
D 1152, F 4608, against ~16 KB moved and the experts' weights read once a
call.

Design (CUDA C++, sm_90a, ``csrc/moe_experts.cu``): one source, two modes,
launched one after the other. ``moe_gate_up_kernel`` gathers A's rows from
x by ``order`` in its copies (no permuted copy of x), multiplies by the
expert's gate and up weights packed by :func:`pack_gate_up` (each 128 rows:
64 gate and then 64 up rows of the same hidden units, so a thread holds both
sums of a unit), and writes SiLU(g) u as bf16 H in permuted order.
``moe_down_kernel`` multiplies H's rows, contiguous per expert, by the
expert's down weight, scales each row by its routing weight and writes it
to its pair's row. Blocks are two warpgroups on 128 rows of one expert; the
grid is sized from the upper bound of the row tiles, ceil(N k / 128) + E,
and each block finds its (expert, row tile) from the device offsets or
exits, so no count reaches the host. No split-K and no atomics: reruns
agree bit for bit. The products of bf16 values are exact in fp32, so the
kernel differs from the plain version only in the order of the sums (and in
what that does to H's bf16 rounding).

The wrapper takes its route by the rule of ``ops/_build.py`` and declares
no backward; its plain version is :func:`moe_experts_reference`, a loop
over the experts of products on the gathered rows. A call launches both
kernels; the wrapper counts them in ``moe_experts.launches``.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ._build import kernel_wrapper

GROUP = 64      # hidden units of a gate (and of an up) block in the packed weight


@functools.cache
def _gate_up_index(F_: int) -> torch.Tensor:
    """For each row of the packed (2F, D) weight, its row of cat([gate,
    up]): blocks of GROUP gate rows, each followed by the up rows of the same
    units (a last, shorter block where GROUP does not divide F)."""
    idx = []
    for g0 in range(0, F_, GROUP):
        n = min(GROUP, F_ - g0)
        idx += list(range(g0, g0 + n)) + list(range(F_ + g0, F_ + g0 + n))
    return torch.tensor(idx)


def pack_gate_up(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """(E, F, D) gate and up weights -> the packed (E, 2F, D) the kernel
    reads."""
    idx = _gate_up_index(gate.shape[1]).to(gate.device)
    return torch.cat([gate, up], dim=1).index_select(1, idx)


def unpack_gate_up(w_gu: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of :func:`pack_gate_up`: (gate, up), each (E, F, D)."""
    F_ = w_gu.shape[1] // 2
    inv = torch.argsort(_gate_up_index(F_)).to(w_gu.device)
    cat = w_gu.index_select(1, inv)
    return cat[:, :F_], cat[:, F_:]


def moe_experts_reference(x: torch.Tensor, w_gu: torch.Tensor, w_down: torch.Tensor,
                          order: torch.Tensor, offsets: torch.Tensor, weights: torch.Tensor,
                          k: int) -> torch.Tensor:
    """Plain version: for each expert, its rows gathered, fp32 products of
    the operands' values, H rounded to x's dtype, the down product scaled by
    the routing weights; the rows put back in pair order. (N k, D) fp32."""
    gate, up = unpack_gate_up(w_gu)
    bounds = offsets.tolist()
    pieces = []
    for e in range(w_gu.shape[0]):
        rows = order[bounds[e]:bounds[e + 1]].long()
        xe = x.index_select(0, rows // k).float()
        h = F.silu(F.linear(xe, gate[e].float())) * F.linear(xe, up[e].float())
        y = F.linear(h.to(x.dtype).float(), w_down[e].float())
        pieces.append(y * weights.index_select(0, rows)[:, None].float())
    y = torch.cat(pieces)
    return torch.zeros_like(y).index_copy(0, order.long(), y)


def moe_experts_cost(rows: int, D: int, F_: int, E: int) -> Dict[str, Tuple[float, float]]:
    """(FLOP, bytes) of each mode of one call over ``rows`` (token, slot)
    pairs, which do not depend on the routing: gate/up 2 rows D 2F, down
    2 rows F D on the bf16 tensor cores; every expert's weights read once,
    the gathered rows of x read once, H written once and read once, the
    fp32 slot outputs written once, ``order`` (and the weights) read once."""
    return {'gate_up': (2.0 * rows * D * 2 * F_,
                        float(E * 2 * F_ * D * 2 + rows * D * 2 + rows * F_ * 2 + rows * 4)),
            'down': (2.0 * rows * F_ * D,
                     float(E * D * F_ * 2 + rows * F_ * 2 + rows * D * 4 + rows * 8))}


@kernel_wrapper(moe_experts_reference)
def moe_experts(x: torch.Tensor, w_gu: torch.Tensor, w_down: torch.Tensor, order: torch.Tensor,
                offsets: torch.Tensor, weights: torch.Tensor, k: int) -> torch.Tensor:
    """Each routed pair's weighted expert output, (N k, D) fp32, from the
    tokens x (N, D), the packed gate/up weights (E, 2F, D)
    (:func:`pack_gate_up`), the down weights (E, D, F), ``order`` (N k,),
    ``offsets`` (E + 1,) and the pairs' routing weights (N k,). On CUDA
    tensors x and the weights are contiguous bf16, order and offsets int32,
    the routing weights fp32; D % 192 == 0 and F % 128 == 0."""
    N, D = x.shape
    E, F2, _ = w_gu.shape
    F_, rows = F2 // 2, x.shape[0] * k
    if w_gu.shape != (E, F2, D) or w_down.shape != (E, D, F_) or order.shape != (rows,) \
            or offsets.shape != (E + 1,) or weights.shape != (rows,):
        raise ValueError(f'moe_experts: x {tuple(x.shape)}, w_gu {tuple(w_gu.shape)}, '
                         f'w_down {tuple(w_down.shape)}, order {tuple(order.shape)}, '
                         f'offsets {tuple(offsets.shape)}, weights {tuple(weights.shape)} '
                         f'do not agree at k {k}')
    if not (x.dtype == w_gu.dtype == w_down.dtype == torch.bfloat16) \
            or order.dtype != torch.int32 or offsets.dtype != torch.int32 \
            or weights.dtype != torch.float32:
        raise ValueError('moe_experts: takes bf16 x and weights, int32 order and offsets, '
                         'fp32 routing weights')
    if D % 192 or F_ % 128:
        raise ValueError(f'moe_experts: D {D} must be a multiple of 192 and F {F_} of 128')
    ts = (x, w_gu, w_down, order, offsets, weights)
    if not all(t.is_contiguous() for t in ts) or any(t.data_ptr() % 16 for t in ts):
        raise ValueError('moe_experts: takes contiguous, 16-byte aligned tensors')
    if N == 0:
        raise ValueError('moe_experts: takes at least one token')
    h = torch.empty((rows, F_), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((rows, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib().moe_experts_bf16(
            x.data_ptr(), w_gu.data_ptr(), w_down.data_ptr(), order.data_ptr(),
            offsets.data_ptr(), weights.data_ptr(), h.data_ptr(), out.data_ptr(),
            rows, D, F_, E, k, torch.cuda.current_stream().cuda_stream)
    _build.check(err, 'moe_experts')
    moe_experts.launches += 2
    return out
