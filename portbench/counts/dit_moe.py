"""Work of one sparse-expert DiT forward at a batch, from the shapes.

``walk`` counts the products of ``counts/dit.py``'s DiT with each block's
MLP replaced by the sparse-expert layer (2 per multiply-add): the router
(2 N D E over the N = B T tokens), the routed experts over the N k (token,
slot) rows (2 rows D 2F for gate and up, 2 rows F D for down: the same
whatever the routing), and the shared expert (2 N D 2Fs + 2 N Fs D). It
is the numerator of ``mfu.dit`` in this cell; elementwise work (softmax, top k, counts,
permutation, SwiGLU, sums) is left out, as in ``counts/dit.py``. ``experts``
lists each block's expert call as (rows, D, F, E), and
:func:`experts_cost` gives each of its two kernels' (FLOP, bytes): a frozen
copy of ``meshdiffusion_tpu_torch/ops/moe_experts.py::moe_experts_cost``.
"""

from __future__ import annotations

from typing import Dict, Tuple

from . import dit


def experts_cost(rows: int, D: int, F: int, E: int) -> Dict[str, Tuple[float, float]]:
    """{'gate_up': (FLOP, bytes), 'down': (FLOP, bytes)}: every expert's
    bf16 weights read once, the gathered bf16 rows read once, the bf16 H
    written once and read once, the fp32 slot outputs written once, the
    int32 order (and the fp32 routing weights) read once."""
    return {'gate_up': (2.0 * rows * D * 2 * F,
                        float(E * 2 * F * D * 2 + rows * D * 2 + rows * F * 2 + rows * 4)),
            'down': (2.0 * rows * F * D,
                     float(E * D * F * 2 + rows * F * 2 + rows * D * 4 + rows * 8))}


def walk(a: dict, B: int) -> Dict[str, object]:
    """{'flops': float, 'attn': [(B, T, H, dh)] a block, 'experts': [(rows,
    D, F, E)] a block} of one forward at batch B."""
    D, E, k, F, Fs = a['D'], a['E'], a['k'], a['F'], a['Fs']
    N = B * (a['R'] // a['p']) ** 3
    out = dit.walk(dict(a, mlp=0), B)
    rows = N * k
    moe = (2.0 * N * D * E + sum(f for f, _ in experts_cost(rows, D, F, E).values())
           + 2.0 * N * D * 2 * Fs + 2.0 * N * Fs * D)
    out['flops'] += a['depth'] * moe
    out['experts'] = [(rows, D, F, E)] * a['depth']
    return out
