"""Reverse-diffusion samplers: the PC sampler (unconditional, trajectory
capture, conditional inpainting) and DDIM.

Counterpart of ``meshdiffusion_tpu/diffusion/sampling.py`` (StepTables, the
predictors ancestral / Euler-Maruyama / reverse-diffusion / none, the
correctors Langevin / ALD / none, ``get_pc_sampler``, ``get_ddim_sampler``,
``get_sampling_fn``; reference ``lib/diffusion/sampling.py``). PyTorch runs
eagerly, so each reverse loop is a Python loop over per-step fp32 tables.
The ancestral predictor's masked update is ``ops.ancestral_update`` (a
Triton kernel on the card); the other updates and the conditional
mask-and-replace of the SDF channel are plain torch, as they are jnp in the
JAX package. As there, the reference's double-index bug in the conditional
init (reference sampling.py:436-439) is not copied.

Noise is injectable: ``noise(name, shape, i=-1, j=0) -> Tensor`` draws one
standard normal tensor, named so that a test can replay another framework's
draws:

* ``'prior'`` the initial sample (also the interpolation endpoints of
  ``evaler.uncond_gen_interp``);
* ``'init'`` the conditional init's noise on the partial SDF channel;
* ``'corrector'`` step ``i``, inner step ``j``;
* ``'predictor'`` step ``i``;
* ``'replace'`` the conditional replace noise of step ``i``.

The default (:func:`default_noise`) draws from a seeded ``torch.Generator``
on the sampling device.

Each step of a reverse loop runs inside a ``sampler.step`` span
(``utils/trace.py``) whose ``i`` is the loop's step index.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import ops
from ..utils import trace
from .vpsde import VPSDE

# model_fn(x, labels) -> epsilon prediction; score = -eps_hat / std
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
NoiseFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StepTables:
    """Per-step fp32 coefficient tables for the reverse loop (row i = step i)."""
    t: np.ndarray                 # continuous time, linspace(T, eps, N)
    labels: np.ndarray            # float model labels t*(N-1)
    beta: np.ndarray              # discrete_betas[floor(t*(N-1)/T)]
    alpha: np.ndarray             # alphas[idx]
    sqrt_beta: np.ndarray
    inv_sqrt_1m_beta: np.ndarray  # 1/sqrt(1-beta)
    std: np.ndarray               # sqrt_1m_alphas_cumprod[idx] (epsilon->score)
    marg_coeff: np.ndarray        # marginal mean coefficient at t
    marg_std: np.ndarray          # marginal std at t

    @staticmethod
    def build(sde: VPSDE, eps: float = 1e-3) -> "StepTables":
        t = sde.timesteps(eps).astype(np.float64)
        labels = (t * (sde.N - 1)).astype(np.float32)
        idx = (t * (sde.N - 1) / sde.T).astype(np.int64)
        beta = sde.discrete_betas[idx].astype(np.float64)
        alpha = sde.alphas[idx].astype(np.float64)
        log_mean_coeff = -0.25 * t ** 2 * (sde.beta_1 - sde.beta_0) - 0.5 * t * sde.beta_0
        return StepTables(
            t=t.astype(np.float32),
            labels=labels,
            beta=beta.astype(np.float32),
            alpha=alpha.astype(np.float32),
            sqrt_beta=np.sqrt(beta).astype(np.float32),
            inv_sqrt_1m_beta=(1.0 / np.sqrt(1.0 - beta)).astype(np.float32),
            std=sde.sqrt_1m_alphas_cumprod[idx].astype(np.float32),
            marg_coeff=np.exp(log_mean_coeff).astype(np.float32),
            marg_std=np.sqrt(1.0 - np.exp(2.0 * log_mean_coeff)).astype(np.float32),
        )


def _labels(x: torch.Tensor, value) -> torch.Tensor:
    return torch.full((x.shape[0],), float(value), dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------
# predictors: (model_fn, sde, tables, i, x, noise, mask) -> masked (x, x_mean)
# --------------------------------------------------------------------------

def ancestral_step(model_fn: ModelFn, sde: VPSDE, tables: StepTables, i: int,
                   x: torch.Tensor, noise: torch.Tensor, mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DDPM ancestral update of step i, masked (reference sampling.py:222-230
    and the grid-mask multiplies at :476-478), through the fused kernel."""
    eps_hat = model_fn(x, _labels(x, tables.labels[i]))
    return ops.ancestral_update(x.contiguous(), eps_hat.contiguous(), mask,
                                noise.contiguous(), float(tables.beta[i]), float(tables.std[i]))


def euler_maruyama_step(model_fn: ModelFn, sde: VPSDE, tables: StepTables, i: int,
                        x: torch.Tensor, noise: torch.Tensor, mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euler-Maruyama on the reverse SDE (reference sampling.py:185-196)."""
    f32 = np.float32
    score = -model_fn(x, _labels(x, tables.labels[i])) / float(tables.std[i])
    beta_t = f32(sde.beta_0) + tables.t[i] * f32(sde.beta_1 - sde.beta_0)
    drift = float(f32(-0.5) * beta_t) * x - float(beta_t) * score
    x_mean = x + drift * float(f32(-1.0 / sde.N))
    x_new = x_mean + float(np.sqrt(beta_t) * f32(np.sqrt(1.0 / sde.N))) * noise
    return x_new * mask, x_mean * mask


def reverse_diffusion_step(model_fn: ModelFn, sde: VPSDE, tables: StepTables, i: int,
                           x: torch.Tensor, noise: torch.Tensor, mask: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse-diffusion discretization (reference sampling.py:199-209)."""
    score = -model_fn(x, _labels(x, tables.labels[i])) / float(tables.std[i])
    G = tables.sqrt_beta[i]
    rev_f = (float(np.sqrt(tables.alpha[i])) * x - x) - float(G * G) * score
    x_mean = x - rev_f
    return (x_mean + float(G) * noise) * mask, x_mean * mask


_PREDICTORS = {'ancestral_sampling': ancestral_step, 'euler_maruyama': euler_maruyama_step,
               'reverse_diffusion': reverse_diffusion_step, 'none': None}


# --------------------------------------------------------------------------
# correctors: (model_fn, tables, i, x, draw(j), snr, n_steps) -> (x, x_mean)
# --------------------------------------------------------------------------

def langevin_step(model_fn: ModelFn, tables: StepTables, i: int, x: torch.Tensor,
                  draw: Callable[[int], torch.Tensor], snr: float, n_steps: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Langevin MCMC corrector (reference sampling.py:259-286); the step
    size uses the batch mean of the per-sample L2 norms."""
    labels = _labels(x, tables.labels[i])
    x_mean = x
    for j in range(n_steps):
        grad = -model_fn(x, labels) / float(tables.std[i])
        noise = draw(j)
        grad_norm = torch.linalg.norm(grad.reshape(grad.shape[0], -1), dim=-1).mean()
        noise_norm = torch.linalg.norm(noise.reshape(noise.shape[0], -1), dim=-1).mean()
        step_size = (snr * noise_norm / grad_norm) ** 2 * 2 * float(tables.alpha[i])
        x_mean = x + step_size * grad
        x = x_mean + torch.sqrt(step_size * 2) * noise
    return x, x_mean


def ald_step(model_fn: ModelFn, tables: StepTables, i: int, x: torch.Tensor,
             draw: Callable[[int], torch.Tensor], snr: float, n_steps: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Annealed Langevin dynamics (reference sampling.py:289-321); the step
    size comes from the marginal std."""
    labels = _labels(x, tables.labels[i])
    f32 = np.float32
    step_size = (f32(snr) * tables.marg_std[i]) ** 2 * f32(2) * tables.alpha[i]
    x_mean = x
    for j in range(n_steps):
        grad = -model_fn(x, labels) / float(tables.std[i])
        noise = draw(j)
        x_mean = x + float(step_size) * grad
        x = x_mean + noise * float(np.sqrt(step_size * f32(2)))
    return x, x_mean


_CORRECTORS = {'langevin': langevin_step, 'ald': ald_step, 'none': None}


def default_noise(device, seed: int) -> NoiseFn:
    """Standard normal draws from one torch.Generator on ``device``, in call
    order (the names only label the draws)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def noise(name, shape, i=-1, j=0):
        return torch.randn(shape, generator=gen, device=device)
    return noise


def _prior_and_mask(shape, grid_mask, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x * mask, mask): the grid mask, all ones when none was given, on x's device."""
    mask = (torch.ones((1,) + tuple(shape[1:4]) + (1,), device=x.device) if grid_mask is None
            else grid_mask.float().contiguous())
    return x.float() * mask, mask


# --------------------------------------------------------------------------
# PC sampler
# --------------------------------------------------------------------------

def get_pc_sampler(sde: VPSDE, shape: Tuple[int, ...],
                   predictor: str = 'ancestral_sampling', corrector: str = 'none',
                   snr: float = 0.075, n_steps: int = 1, probability_flow: bool = False,
                   denoise: bool = True, eps: float = 1e-3,
                   grid_mask: Optional[torch.Tensor] = None, return_traj: bool = False,
                   traj_start: int = 700, traj_every: int = 10):
    """PC sampler over channels-last (B, R, R, R, C) grids.

    Returns ``sampler(model_fn, noise, partial=None, partial_mask=None,
    freeze_iters=None) -> (samples, nfe)``:

    * unconditional (``partial`` None): N-1 steps over timesteps[0..N-2]
      (reference :471), corrector then predictor, the grid mask multiplied
      into x and x_mean after each; x_mean is returned when ``denoise``.
      With ``return_traj`` it returns instead the clipped x0 predictions of
      the steps ``i >= traj_start`` with ``i % traj_every == 0``, stacked
      (n_traj, B, R, R, R, C), slot ``(i - traj_start) // traj_every``
      (unwritten slots stay zero); each costs one more forward, computed
      only at those steps, and counted in ``nfe``;
    * conditional: ``partial`` / ``partial_mask`` (1, R, R, R, 1) SDF-channel
      grids. N steps; after the predictor, the SDF channel is replaced by
      the partial noised to the step's level inside the mask while
      ``i < freeze_iters`` and ``i != N - 1`` (x_mean's too). The init sets
      channel 0 of every sample to the partial, noised to T inside the mask.
    """
    if probability_flow:
        raise NotImplementedError('probability_flow PC sampling is not used by any '
                                  'reference config (ancestral asserts against it)')
    pred_name, corr_name = predictor.lower(), corrector.lower()
    if pred_name not in _PREDICTORS or corr_name not in _CORRECTORS:
        raise ValueError(f'unknown predictor {predictor!r} or corrector {corrector!r}')
    pred_fn, corr_fn = _PREDICTORS[pred_name], _CORRECTORS[corr_name]
    tables = StepTables.build(sde, eps)
    N = sde.N
    n_traj = (N - 1 - traj_start + traj_every - 1) // traj_every if return_traj else 0
    nfe = N * (n_steps + 1)

    def step(model_fn, noise, i, x, mask):
        """Corrector then predictor at step i, each followed by the mask."""
        with trace.span('sampler.step', i=i):
            if corr_fn is not None:
                x, x_mean = corr_fn(model_fn, tables, i, x,
                                    lambda j: noise('corrector', shape, i, j).float(), snr,
                                    n_steps)
                x = x * mask
            if pred_fn is None:
                x = x * mask
                return x, x
            return pred_fn(model_fn, sde, tables, i, x, noise('predictor', shape, i).float(),
                           mask)

    def xzero(model_fn, x, i, mask):
        """Clipped x0 prediction (reference sampling.py:410-420); the table
        index in fp32, as the JAX package computes it."""
        f32 = np.float32
        k = int(tables.t[i] * f32(N - 1) / f32(sde.T))
        eps_hat = model_fn(x, _labels(x, tables.labels[i]))
        x0 = (x - float(tables.std[i]) * eps_hat) / float(f32(sde.sqrt_alphas_cumprod[k]))
        return x0.clamp(-1.0, 1.0) * mask

    def uncond(model_fn, noise):
        x, mask = _prior_and_mask(shape, grid_mask, noise('prior', shape))
        x_mean = x
        traj = torch.zeros((max(n_traj, 1),) + tuple(shape), device=x.device) if return_traj \
            else None
        captured = 0
        for i in range(N - 1):
            x, x_mean = step(model_fn, noise, i, x, mask)
            if return_traj and i >= traj_start and i % traj_every == 0:
                traj[min((i - traj_start) // traj_every, max(n_traj - 1, 0))] = \
                    xzero(model_fn, x, i, mask)
                captured += 1
        if return_traj:
            return traj, nfe + captured
        return (x_mean if denoise else x), nfe

    def cond(model_fn, noise, partial, partial_mask, freeze_iters):
        x, mask = _prior_and_mask(shape, grid_mask, noise('prior', shape))
        gm0 = mask[..., 0]                                   # (1, R, R, R)
        p = partial.float()[..., 0] * gm0
        m = partial_mask.float()[..., 0]
        noised0 = float(tables.marg_coeff[0]) * p + float(tables.marg_std[0]) * \
            noise('init', tuple(p.shape)).float()
        x[..., 0] = ((p * (1 - m) + noised0 * m) * gm0).expand(x.shape[:-1])
        x_mean = x
        for i in range(N):
            x, x_mean = step(model_fn, noise, i, x, mask)
            if i < freeze_iters and i != N - 1:
                noised = float(tables.marg_coeff[i]) * p + float(tables.marg_std[i]) * \
                    noise('replace', tuple(p.shape), i).float()
                ch0 = (x[..., 0] * (1 - m) + noised * m) * gm0
                x[..., 0] = ch0
                x_mean[..., 0] = ch0
        return (x_mean if denoise else x), nfe

    def sampler(model_fn: ModelFn, noise: NoiseFn, partial=None, partial_mask=None,
                freeze_iters: Optional[int] = None) -> Tuple[torch.Tensor, int]:
        if partial is None:
            return uncond(model_fn, noise)
        return cond(model_fn, noise, partial, partial_mask,
                    N + 10 if freeze_iters is None else freeze_iters)

    return sampler


# --------------------------------------------------------------------------
# DDIM sampler
# --------------------------------------------------------------------------

def ddim_schedule(sde: VPSDE, schedule: str = 'quad', num_steps: int = 100) -> np.ndarray:
    """Timestep sequence for DDIM (reference sampling.py:544-556)."""
    if schedule == 'uniform':
        seq = np.arange(0, sde.N, sde.N // num_steps)
    elif schedule == 'quad':
        seq = (np.linspace(0, np.sqrt(sde.N * 0.8), num_steps) ** 2).astype(np.int64)
    else:
        raise ValueError(schedule)
    return (np.asarray(seq, np.float64) / sde.N).astype(np.float32)


def get_ddim_sampler(sde: VPSDE, shape: Tuple[int, ...], denoise: bool = False,
                     eps: float = 1e-3, grid_mask: Optional[torch.Tensor] = None,
                     schedule: str = 'quad', num_steps: int = 100):
    """DDIM sampler in fp32 (reference sampling.py:500-570), its coefficient
    tables built in fp64 numpy. The pairs (t_i, t_{i-1}) run in reverse;
    ``denoise`` returns the last x0 prediction instead of x.

    Returns ``sampler(model_fn, noise, x0=None, partial=None,
    partial_mask=None) -> (samples, nfe)``; ``x0`` replaces the prior draw,
    and a partial re-imposes channel 0 inside its mask on x and on the x0
    prediction every step."""
    ts = ddim_schedule(sde, schedule, num_steps)
    t_seq = ts[1:][::-1].copy()
    tprev_seq = ts[:-1][::-1].copy()
    N = sde.N
    idx = np.clip((t_seq * (N - 1)).astype(np.int64), 0, N - 1)
    idx_prev = np.clip((tprev_seq * (N - 1)).astype(np.int64), 0, N - 1)
    a1, a2 = sde.sqrt_alphas_cumprod[idx], sde.sqrt_1m_alphas_cumprod[idx]
    a1p, a2p = sde.sqrt_alphas_cumprod[idx_prev], sde.sqrt_1m_alphas_cumprod[idx_prev]
    f32 = np.float32
    rows = list(zip((t_seq * (N - 1)).astype(f32), a1.astype(f32), a2.astype(f32),
                    (a1p / a1).astype(f32), (a2p / a2).astype(f32)))

    def sampler(model_fn: ModelFn, noise: NoiseFn, x0=None, partial=None, partial_mask=None
                ) -> Tuple[torch.Tensor, int]:
        x, mask = _prior_and_mask(shape, grid_mask, noise('prior', shape) if x0 is None else x0)
        if partial is not None:
            p, m = partial.float()[..., 0], partial_mask.float()[..., 0]
            x[..., 0] = x[..., 0] * (1 - m) + p * m
        x0_pred = torch.zeros_like(x)
        for i, (label, c1, c2, r1, r2) in enumerate(rows):
            with trace.span('sampler.step', i=i):
                eps_hat = model_fn(x, _labels(x, label))
                x0_scaled = x - float(c2) * eps_hat
                score_scaled = x - x0_scaled
                x0_pred = x0_scaled / float(c1) * mask
                x = (float(r1) * x + float(-r1 + r2) * score_scaled) * mask
                if partial is not None:
                    x[..., 0] = x[..., 0] * (1 - m) + p * m
                    x0_pred[..., 0] = x0_pred[..., 0] * (1 - m) + p * m
        return (x0_pred if denoise else x) * mask, N * 2

    return sampler


def get_sampling_fn(config, sde: VPSDE, shape, eps: float = 1e-3, grid_mask=None,
                    return_traj: bool = False):
    """Config-driven sampler factory (reference sampling.py:83-132)."""
    name = config.sampling.method.lower()
    if name == 'pc':
        return get_pc_sampler(sde, shape, predictor=config.sampling.predictor,
                              corrector=config.sampling.corrector, snr=config.sampling.snr,
                              n_steps=config.sampling.n_steps_each,
                              probability_flow=config.sampling.probability_flow,
                              denoise=config.sampling.noise_removal, eps=eps,
                              grid_mask=grid_mask, return_traj=return_traj)
    if name == 'ddim':
        return get_ddim_sampler(sde, shape, denoise=config.sampling.noise_removal, eps=eps,
                                grid_mask=grid_mask)
    raise ValueError(f'Sampler name {name} unknown.')
