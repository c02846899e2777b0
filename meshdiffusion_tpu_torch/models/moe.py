"""The sparse-expert FFN of DiT-MoE (Fei et al., arXiv:2407.11633;
``SparseMoeBlock`` of feizc/DiT-MoE's ``models.py``), in the DiT block's
MLP place (``models/dit3d.py``).

For the modulated tokens x (N, D), fp32:

* router: p = softmax(x ``gate.weight``^T) over the E experts, fp32, no
  bias; each token's top k experts (``torch.topk``), weighted by their
  probabilities as they are (DeepSeekMoE's gate with ``norm_topk_prob``
  off, as DiT-MoE's ``MoEGate``);
* routed experts: each a SwiGLU, ``down_proj(SiLU(gate_proj(x))
  * up_proj(x))``, hidden width F, no biases (DiT-MoE's ``MoeMLP``; here
  :class:`Expert`, the weights alone);
* shared expert ``shared_experts``: one SwiGLU MoeMLP of width Fs (DiT-MoE's
  ``num_shared_experts`` times D), which every token passes;
* y = sum over the token's k slots of p_e E_e(x), then + S(x), in that order.

State-dict names follow DiT-MoE's module: ``experts.{e}.{gate,up,down}_proj
.weight``, ``gate.weight`` (E, D), ``shared_experts.{gate,up,down}_proj
.weight``; the block holds it as ``moe``. No token is dropped, whatever the
imbalance: an expert may get no row or all of them. The load-balancing loss
of DiT-MoE's training is not computed (sampling reads none; the port's
trainer has no such term).

Routing stays on the device, with no synchronisation of the host
(:func:`route`): softmax, top k, the per-expert counts by ``scatter_add_``,
their exclusive ``cumsum`` as the offsets, and the slot permutation as a
stable sort of the (token, slot) pairs by expert. The routed experts are one
call of ``ops.moe_experts`` (the grouped kernel on CUDA tensors, a loop over
the experts otherwise); their weights are packed once into its bf16 layout
(``ops.pack_gate_up``; rebuilt when a weight changes, counted as
``rebuild.pack``). The shared expert runs as two plain products (gate and up
as one) in the compute dtype, with its SwiGLU in that dtype.

Spans: ``moe.route`` (the router to the permutation) and ``moe.combine``
(the slots' and the shared expert's sum), inside the block's ``dit.moe``.
While :attr:`SparseMoeBlock.routes` is a list, each forward appends its
top-k expert ids (N, k) to it, on the device: the switch that lets a caller
read the routes of a forward it runs anyway.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import ops
from ..utils import trace
from .layers import _Derived


def route(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, ...]:
    """(top_p (N, k) fp32, top_i (N, k) int64, order (N k,) int32, offsets
    (E + 1,) int32) of router logits (N, E): the softmax's top k, sorted;
    ``order`` the pairs token * k + slot in a stable sort by expert, expert
    e's at ``order[offsets[e]:offsets[e + 1]]``. Device ops only."""
    E = logits.shape[-1]
    top_p, top_i = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    flat = top_i.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int32, device=logits.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0, dtype=torch.int32)])
    order = torch.sort(flat, stable=True).indices.to(torch.int32)
    return top_p, top_i, order, offsets


class Expert(nn.Module):
    """A routed expert's weights under DiT-MoE's ``MoeMLP`` names, no
    biases. Only :meth:`SparseMoeBlock.packed` reads them: the experts run
    in ``ops.moe_experts``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.gate_proj = nn.Linear(dim, hidden, bias=False)
        self.up_proj = nn.Linear(dim, hidden, bias=False)
        self.down_proj = nn.Linear(hidden, dim, bias=False)


class MoeMLP(Expert):
    """DiT-MoE's SwiGLU expert: ``down_proj(SiLU(gate_proj(x)) up_proj(x))``,
    no biases; here the shared expert, which runs itself (:meth:`forward`):
    its operands in the compute dtype, gate and up as one product, SiLU and
    the product in the compute dtype too (each rounded, as DiT-MoE's MoeMLP
    runs under bf16): two passes over the hidden units, where fp32 casts of g
    and u took five."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, hidden)
        self.dtype = dtype
        self._cast = _Derived('rebuild.pack')

    def operands(self):
        """(cat([gate, up]) (2F, D), down (D, F)) in the compute dtype."""
        ws = (self.gate_proj.weight, self.up_proj.weight, self.down_proj.weight)

        def build():
            return (torch.cat(ws[:2]).to(self.dtype), ws[2].to(self.dtype))
        if torch.is_grad_enabled():
            return build()
        return self._cast.get(ws[0], lambda: tuple(t.detach() for t in build()), self.dtype,
                              *((w.data_ptr(), w._version) for w in ws[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_gu, w_down = self.operands()
        g, u = F.linear(x.to(self.dtype), w_gu).chunk(2, dim=-1)
        return F.linear(F.silu(g) * u, w_down)


class MoEGate(nn.Module):
    """The router's weight (E, D), no bias (DiT-MoE's ``MoEGate``)."""

    def __init__(self, dim: int, num_experts: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_experts, dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """DiT-MoE's ``kaiming_uniform_(a=sqrt(5))``: uniform in +-1/sqrt(D)."""
        b = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            self.weight.uniform_(-b, b, generator=generator)


class SparseMoeBlock(nn.Module):
    """E routed SwiGLU experts of width F (top k a token) and one shared
    expert of width Fs (module docstring). Takes and returns fp32 (B, T, D)."""

    def __init__(self, dim: int, num_experts: int, experts_per_token: int, expert_hidden: int,
                 shared_expert_hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k, self.dtype = experts_per_token, dtype
        self.experts = nn.ModuleList(Expert(dim, expert_hidden) for _ in range(num_experts))
        self.gate = MoEGate(dim, num_experts)
        self.shared_experts = MoeMLP(dim, shared_expert_hidden, dtype)
        self._pack = _Derived('rebuild.pack')
        self.routes: Optional[List[torch.Tensor]] = None

    def packed(self):
        """(packed gate/up (E, 2F, D), down (E, D, F)) in the compute dtype:
        what ``ops.moe_experts`` reads."""
        ws = [w for ex in self.experts
              for w in (ex.gate_proj.weight, ex.up_proj.weight, ex.down_proj.weight)]

        def build():
            gate = torch.stack(ws[0::3])
            up = torch.stack(ws[1::3])
            return (ops.pack_gate_up(gate, up).to(self.dtype).contiguous(),
                    torch.stack(ws[2::3]).to(self.dtype).contiguous())
        if torch.is_grad_enabled():
            return build()
        return self._pack.get(ws[0], lambda: tuple(t.detach() for t in build()), self.dtype,
                              *((w.data_ptr(), w._version) for w in ws[1:]))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        shape = h.shape
        h = h.reshape(-1, shape[-1])
        with trace.span('moe.route'):
            top_p, top_i, order, offsets = route(F.linear(h, self.gate.weight), self.k)
            if self.routes is not None:
                self.routes.append(top_i)
        x = h.to(self.dtype)
        slots = ops.moe_experts(x, *self.packed(), order, offsets, top_p.reshape(-1),
                                self.k).view(-1, self.k, shape[-1])
        shared = self.shared_experts(x)
        with trace.span('moe.combine'):
            y = slots[:, 0]
            for j in range(1, self.k):
                y = y + slots[:, j]
            y = y + shared
        return y.reshape(shape)
