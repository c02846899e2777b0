"""DDPM loss, optimizer, EMA and the train step.

Counterpart of ``meshdiffusion_tpu/diffusion/losses.py`` (reference
``lib/diffusion/losses.py``: Adam factory:26-35, warmup + clip:38-52, the
masked epsilon loss:54-85, the step:87-141):

* the optimizer is ``torch.optim.Adam`` (b2 0.999) behind optax's chain:
  decayed weights added to the gradients, then ``clip_by_global_norm``
  (g * clip / |g| only when |g| >= clip), then Adam at the warm-up rate
  lr * min(n / warmup, 1) for the n-th update, 0-based, so the first
  update moves nothing when warmup > 0;
* gradient accumulation over ``iter_size`` micro-batches sums the
  gradients, as repeated ``loss.backward()`` calls do, and reports the
  mean of the micro-batch losses; then one optimizer step and one EMA
  update;
* the timestep labels and the noise of each micro-batch come from a
  source the caller may replace (:func:`torch_source` by default), so a
  test can replay the JAX package's key splits.

On a (data, spatial) rank mesh (``parallel/``) each rank holds its data
row's share of the micro-batch and, with ``spatial`` > 1, its depth slab of
each grid: the loss sums its slab's terms and then over the row's ranks,
spatial peers draw the same labels and the whole grid's noise (each keeps
its slab), and once a step the gradients are summed over every rank and
divided by the data axis, what JAX's psum under the mesh gives: every rank
then clips and steps on the same gradient.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.func import functional_call

from ..parallel import spatial
from ..utils.checkpoint import EMA
from .vpsde import VPSDE

# (micro-batch index, micro-batch shape) -> (labels (B,) int64, noise of that shape)
Source = Callable[[int, Tuple[int, ...]], Tuple[torch.Tensor, torch.Tensor]]


class Optimizer:
    """Adam with optax's warm-up, global-norm clip and weight decay
    (JAX ``get_optimizer``). Its ``state_dict`` is Adam's, which is what the
    reference's checkpoints hold."""

    def __init__(self, params, config):
        o = config.optim
        if o.optimizer != 'Adam':
            raise NotImplementedError(f'Optimizer {o.optimizer} not supported yet!')
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.warmup = float(o.lr), int(o.warmup)
        self.grad_clip, self.weight_decay = float(o.grad_clip), float(o.weight_decay)
        self.adam = torch.optim.Adam(self.params, lr=self.lr, betas=(o.beta1, 0.999),
                                     eps=o.eps)

    def lr_at(self, n: int) -> float:
        """The rate of the n-th update (0-based)."""
        return self.lr * min(n / self.warmup, 1.0) if self.warmup > 0 else self.lr

    @torch.no_grad()
    def step(self, n: int) -> torch.Tensor:
        """Apply the n-th update from the parameters' ``.grad`` and clear
        them; returns the gradients' global norm (after the weight decay),
        a tensor on their device, so that the host does not wait for it."""
        for p in self.params:
            if p.grad is None:      # a parameter the forward does not use: a zero gradient
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.weight_decay:
            torch._foreach_add_(grads, [p.detach() for p in self.params],
                                alpha=self.weight_decay)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.grad_clip >= 0:
            # optax clip_by_global_norm: select(norm < clip, g, g / norm * clip)
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            torch._foreach_mul_(grads, scale)
        for group in self.adam.param_groups:
            group['lr'] = self.lr_at(n)
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        return norm

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)


def get_optimizer(config, params) -> Optimizer:
    return Optimizer(params, config)


@dataclass
class TrainState:
    step: int                     # optimizer steps taken
    model: torch.nn.Module
    optimizer: Optimizer
    ema: EMA
    generator: torch.Generator    # labels and noise of the default source

    @classmethod
    def create(cls, model, config, generator: torch.Generator) -> "TrainState":
        return cls(0, model, get_optimizer(config, model.parameters()),
                   EMA(model, config.model.ema_rate), generator)


def torch_source(generator: torch.Generator, N: int) -> Source:
    """Labels uniform in [0, N) and standard normal noise from ``generator``
    (on the device the batch lies on)."""
    def draw(_, shape):
        dev = generator.device
        labels = torch.randint(0, N, (shape[0],), generator=generator, device=dev)
        return labels, torch.randn(shape, generator=generator, device=dev)
    return draw


def ddpm_loss(model, batch: torch.Tensor, labels: torch.Tensor, noise: torch.Tensor,
              sqrt_ac: torch.Tensor, sqrt_1m_ac: torch.Tensor, mask: Optional[torch.Tensor],
              loss_type: str = 'l2', train: bool = True) -> torch.Tensor:
    """Masked epsilon-prediction loss (JAX ``ddpm_loss``; reference
    losses.py:54-85). batch (B, R, R, R, C) channels-last; mask
    (1, R, R, R, 1) or None; a scalar."""
    a = sqrt_ac[labels][:, None, None, None, None]
    s = sqrt_1m_ac[labels][:, None, None, None, None]
    perturbed = a * batch + s * noise
    if mask is not None:
        perturbed = perturbed * mask
    eps_hat = model(perturbed, labels.float(), mask, train=train)
    if loss_type == 'l2':
        losses = torch.square(eps_hat - noise)
    elif loss_type == 'l1':
        losses = torch.abs(eps_hat - noise)
    else:
        raise NotImplementedError(loss_type)
    if mask is not None:
        losses = losses * mask
    if spatial.current() is not None:
        return _sharded_loss(losses, mask)
    loss = losses.reshape(losses.shape[0], -1).mean(dim=-1).mean()
    if mask is not None:
        # reweight by the mask's density: x R^3 / sum(mask) (reference losses.py:78)
        loss = loss * (mask.numel() / mask.sum())
    return loss


def _sharded_loss(losses: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`ddpm_loss` over the whole grid from this rank's depth slab of
    its terms (and of the mask): the slab's sum, summed over the slabs, over
    the whole grid's element count; the mask's density from its whole sum."""
    S = spatial.current().size
    loss = spatial.sum_over_ranks(losses.sum()) / (losses.numel() * S)
    if mask is not None:
        with torch.no_grad():
            total = spatial.sum_over_ranks(mask.sum().float())
        loss = loss * (mask.numel() * S / total)
    return loss


def _tables(sde: VPSDE, device):
    return (torch.as_tensor(sde.sqrt_alphas_cumprod, dtype=torch.float32, device=device),
            torch.as_tensor(sde.sqrt_1m_alphas_cumprod, dtype=torch.float32, device=device))


def all_reduce_grads(params, mesh) -> None:
    """Sum every parameter's gradient over the mesh's ranks, in one flat
    buffer, and divide by the data axis: the mean over the data rows of
    each row's gradient, whose slabs' parts the sum adds up (JAX's psum of
    the gradients under the mesh). Every rank holds the same sum after."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch._utils._flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.data
    for p, g in zip(params, torch._utils._unflatten_dense_tensors(flat, grads)):
        p.grad = g


def make_train_step(sde: VPSDE, mask: Optional[torch.Tensor], loss_type: str = 'l2',
                    mesh=None):
    """The train step (JAX ``make_train_step``): ``step(state, batch,
    source=None)`` with batch (iter_size, micro_bs, R, R, R, C) runs the
    training forward and backward of each micro-batch, summing the
    gradients, then one optimizer step and one EMA update; it returns
    {'loss': the mean micro-batch loss, 'grad_norm'}, both tensors, so that
    the host runs on to the next batch while the card works.
    ``source`` defaults to :func:`torch_source` of ``state.generator``.

    With a ``mesh`` of more than one rank, batch is this rank's share
    (``parallel.shard_batch(..., spatial=True, batch_dim=1)``): its data
    row's micro_bs samples, and its depth slab where the mesh's spatial axis
    splits the grid (``mask`` is the whole grid's). ``source`` is then asked
    for the data row's whole grids (R planes); the loss reported is the mean
    over the data rows."""
    tables = {}
    multi = mesh is not None and mesh.size > 1

    def train_step(state: TrainState, batch: torch.Tensor, source: Optional[Source] = None):
        dev = batch.device
        if dev not in tables:
            tables[dev] = _tables(sde, dev)
        sqrt_ac, sqrt_1m_ac = tables[dev]
        source = source or torch_source(state.generator, sde.N)
        loss_sum = torch.zeros((), device=dev)
        depth = (0, batch.shape[2])
        if multi and mesh.spatial > 1:
            depth = mesh.depth_range(batch.shape[2] * mesh.spatial)
        m = mask if mask is None else mask[:, depth[0]:depth[1]]
        shape = (batch.shape[1], batch.shape[2] * (mesh.spatial if multi else 1)) \
            + tuple(batch.shape[3:])
        with spatial.sharded(mesh if multi else None):
            for j in range(batch.shape[0]):
                labels, noise = source(j, shape)
                loss = ddpm_loss(state.model, batch[j], labels, noise[:, depth[0]:depth[1]],
                                 sqrt_ac, sqrt_1m_ac, m, loss_type, train=True)
                loss.backward()
                loss_sum += loss.detach()
        if multi:
            all_reduce_grads(state.optimizer.params, mesh)
            dist.all_reduce(loss_sum, group=mesh.data_group)
            loss_sum /= mesh.data
        grad_norm = state.optimizer.step(state.step)
        state.ema.update(state.model)
        state.step += 1
        return {'loss': loss_sum / batch.shape[0], 'grad_norm': grad_norm}

    return train_step


def make_eval_step(sde: VPSDE, mask: Optional[torch.Tensor], loss_type: str = 'l2'):
    """The eval loss on the EMA weights, ``train=False`` (JAX
    ``make_eval_step``; reference losses.py:129-135): ``step(state, batch,
    source=None)`` with batch (B, R, R, R, C) returns {'loss': tensor}. The
    model's own weights are not touched: the call swaps in the EMA's."""
    def eval_step(state: TrainState, batch: torch.Tensor, source: Optional[Source] = None):
        sqrt_ac, sqrt_1m_ac = _tables(sde, batch.device)
        labels, noise = (source or torch_source(state.generator, sde.N))(0, tuple(batch.shape))
        ema_model = lambda *a, **k: functional_call(state.model, state.ema.shadow, a, k)
        with torch.no_grad():
            loss = ddpm_loss(ema_model, batch, labels, noise, sqrt_ac, sqrt_1m_ac, mask,
                             loss_type, train=False)
        return {'loss': loss}

    return eval_step
