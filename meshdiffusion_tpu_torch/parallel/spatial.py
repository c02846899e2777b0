"""The U-Net over a grid whose depth axis is split across ranks.

Under JAX the grid's depth D is sharded over the mesh's ``spatial`` axis and
XLA's SPMD partitioner inserts what the layers then need: the boundary
planes of the neighbouring shards for every k^3 conv, the GroupNorm
reductions across shards, the gather of the keys and values of attention.
PyTorch has no partitioner, so this module writes them out, and the layers
(``models/layers.py``, ``models/unet3d.py``) call them while a
:func:`sharded` context is active; with none active every layer runs its
one-card code.

Every exchange is an ``all_reduce`` over the rank's spatial group (each
rank writes into its own slot of a zero buffer), the one collective that
the gloo backend also carries on CUDA tensors, which is what lets several
ranks share one card:

* :func:`halo` hands each rank the boundary planes of its neighbours
  (none at the grid's ends); its backward sends each halo's gradient back
  to the rank that owns those planes, which adds it to its own;
* :func:`gather` stacks every rank's tensor in rank order (each writes its
  slot, then the all-reduce); its backward is the all-reduce of the
  gradients, each rank keeping its own slot: the reduce-scatter;
* :func:`sum_over_ranks` sums a replicated value (the loss) over the group;
  its backward passes the gradient through once, so that each rank's slab
  adds its own part;
* :func:`gn_affine` gives the whole grid's GroupNorm ``a, b`` from every
  slab's moments (the statistics kernel's moments mode on the card),
  merged in rank order, so every rank folds the same statistics.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import ops


@dataclass(frozen=True)
class Shard:
    """This rank's place along the spatial axis."""
    group: Any          # the spatial group (the ranks of this data row)
    size: int           # ranks along the depth
    index: int          # this rank's slab: planes [index * d, (index + 1) * d)

    def halo_sizes(self, k: int) -> Tuple[int, int]:
        """The planes that :func:`halo` adds before and after a slab for a
        halo of ``k``: none at the grid's ends."""
        return (k if self.index > 0 else 0), (k if self.index < self.size - 1 else 0)


# The shard in effect. Process-wide and not thread-local: autograd's backward
# runs on its own threads, and it reruns the checkpointed blocks there.
_ACTIVE: Optional[Shard] = None


def current() -> Optional[Shard]:
    return _ACTIVE


@contextmanager
def sharded(mesh):
    """Run the U-Net on this rank's depth slab of the grid (the mesh's
    spatial axis; a mesh with one rank along it changes nothing). Keep the
    backward inside too: it reruns checkpointed blocks."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = Shard(mesh.spatial_group, mesh.spatial, mesh.spatial_index) \
        if mesh is not None and mesh.spatial > 1 else None
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


class _Halo(torch.autograd.Function):
    """x (B, D, H, W, C) -> (B, lo + D + hi, H, W, C): the previous rank's
    last ``k_lo`` planes before, the next rank's first ``k_hi`` after."""

    @staticmethod
    def forward(ctx, x, k_lo: int, k_hi: int, shard: Shard):
        S, s, D = shard.size, shard.index, x.shape[1]
        if D < max(k_lo, k_hi):
            raise ValueError(f'a halo of {max(k_lo, k_hi)} planes from a slab of {D}')
        # slot s: this rank's first k_hi planes (the previous rank's hi halo),
        # then its last k_lo (the next rank's lo halo)
        buf = x.new_zeros((S, x.shape[0], k_hi + k_lo) + x.shape[2:])
        buf[s, :, :k_hi] = x[:, :k_hi]
        buf[s, :, k_hi:] = x[:, D - k_lo:]
        dist.all_reduce(buf, group=shard.group)
        lo = [buf[s - 1, :, k_hi:]] if s > 0 and k_lo else []
        hi = [buf[s + 1, :, :k_hi]] if s < S - 1 and k_hi else []
        ctx.args = (k_lo, k_hi, shard, len(lo) and k_lo, len(hi) and k_hi)
        return torch.cat(lo + [x] + hi, dim=1)

    @staticmethod
    def backward(ctx, g):
        k_lo, k_hi, shard, n_lo, n_hi = ctx.args
        S, s = shard.size, shard.index
        D = g.shape[1] - n_lo - n_hi
        gx = g[:, n_lo:n_lo + D].contiguous()
        buf = g.new_zeros((S, g.shape[0], k_hi + k_lo) + g.shape[2:])
        if n_lo:
            buf[s - 1, :, k_hi:] = g[:, :n_lo]          # to the previous rank's last planes
        if n_hi:
            buf[s + 1, :, :k_hi] = g[:, n_lo + D:]      # to the next rank's first planes
        dist.all_reduce(buf, group=shard.group)
        gx[:, :k_hi] += buf[s, :, :k_hi]
        gx[:, D - k_lo:] += buf[s, :, k_hi:]
        return gx, None, None, None


def halo(x: torch.Tensor, k_lo: int, k_hi: int, shard: Optional[Shard] = None) -> torch.Tensor:
    """This rank's slab x (B, D, H, W, C) with the previous rank's last
    ``k_lo`` planes before it and the next rank's first ``k_hi`` after it,
    where there is such a rank (:meth:`Shard.halo_sizes`)."""
    return _Halo.apply(x, k_lo, k_hi, shard or _ACTIVE)


def pad_depth(x: torch.Tensor, k_lo: int, k_hi: int) -> torch.Tensor:
    """:func:`halo`, then zeros where the slab meets the grid's ends: always
    ``k_lo + D + k_hi`` planes, what the unsharded zero padding gives."""
    sh = _ACTIVE
    h = halo(x, k_lo, k_hi, sh)
    lo, hi = sh.halo_sizes(1)
    return F.pad(h, (0, 0, 0, 0, 0, 0, k_lo * (1 - lo), k_hi * (1 - hi)))


class _AllReduce(torch.autograd.Function):
    """The sum over the group; its backward is the sum of the gradients
    (each rank used the sum in its own way)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def gather(x: torch.Tensor, shard: Optional[Shard] = None) -> torch.Tensor:
    """(S, *x.shape): every rank's x in rank order, differentiable (the
    backward all-reduces the gradient and keeps this rank's slot)."""
    sh = shard or _ACTIVE
    slots = torch.stack([x if r == sh.index else torch.zeros_like(x) for r in range(sh.size)])
    return _AllReduce.apply(slots, sh.group)


def gather_depth(x: torch.Tensor) -> torch.Tensor:
    """The whole grid (B, S * D, ...) from every rank's slab (B, D, ...)."""
    g = gather(x)
    return g.movedim(0, 1).reshape((x.shape[0], -1) + x.shape[2:])


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the spatial group; the gradient reaches each
    rank's ``t`` once (the sum is one value, held by every rank)."""
    return _SumOverRanks.apply(t, _ACTIVE.group)


def gn_affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              num_groups: int = 32, eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole grid's GroupNorm folded into per-(B, C) fp32 ``a, b``, from
    this rank's slab x: its moments (``ops.gn_moments``, the kernel on the
    card), gathered and merged in rank order, then folded; differentiable."""
    m = gather(ops.gn_moments(x.contiguous(), num_groups))      # (S, B, G, 2)
    mean, m2, n = ops.merge_moments(m, x[0].numel() // num_groups)
    return ops.affine_from_moments(mean, m2, n, scale, bias, eps)


def groupnorm(x: torch.Tensor, gn, silu: bool = False) -> torch.Tensor:
    """GroupNorm (the ``nn.GroupNorm`` ``gn``'s groups, eps, scale and bias)
    of this rank's slab with the whole grid's statistics, and SiLU with
    ``silu``; in x's dtype, as ``ops.groupnorm_reference``."""
    a, b = gn_affine(x, gn.weight, gn.bias, gn.num_groups, gn.eps)
    h = x.float() * a[:, None, None, None, :] + b[:, None, None, None, :]
    return (F.silu(h) if silu else h).to(x.dtype)
