"""Log-likelihood in bits/dim through the probability-flow ODE.

Counterpart of ``meshdiffusion_tpu/diffusion/likelihood.py`` (reference
``lib/diffusion/likelihood.py:26-113``): the drift and a Hutchinson
estimate of its divergence on the device, the adaptive RK45 controller on
the host (scipy ``solve_ivp``), as in the JAX package and the reference.

The JAX package takes the divergence estimate eps^T (df/dx) eps forward-mode
(``jax.jvp``); here it is reverse-mode (one vector-Jacobian product,
``torch.autograd.grad``), the same quantity summed in another order. Under
autograd the U-Net's GroupNorm -> SiLU -> conv chains run the conv kernel
forward and the plain version's backward, and its other ops their plain
versions (the route rule of ``ops/_build.py``).
The Hutchinson noise is injectable: ``likelihood_fn(noise, data)`` takes a
seed or a noise source ``noise(name, shape)``, as the samplers do.

The network's parameters are constants of the ODE, as JAX's ``jvp`` with
respect to x alone has them: ``model_fn``'s parameters must not require
grad (``model.requires_grad_(False)``). The conv's autograd Function
(``ops._build.PlainBackward``) fixes at its forward which gradients its
backward computes, so a trainable
model would cost a weight-gradient conv at every site of every
evaluation; the first evaluation refuses such a model.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch

from ..utils.device import resolve_device
from .sampling import NoiseFn
from .vpsde import VPSDE


def get_drift_fn(sde: VPSDE, model_fn: Callable) -> Callable:
    """Probability-flow ODE drift f - 0.5 g^2 * score, with
    model_fn(x, labels) the epsilon network and score = -eps_hat / std, std
    from the discrete table at labels = t * (N - 1) (reference
    models/utils.py:191-198)."""
    s1m = torch.as_tensor(sde.sqrt_1m_alphas_cumprod)

    def drift(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        bshape = (-1,) + (1,) * (x.ndim - 1)
        beta_t = (sde.beta_0 + t * (sde.beta_1 - sde.beta_0)).reshape(bshape)
        labels = t * (sde.N - 1)
        std = s1m.to(x.device)[labels.long()].reshape(bshape)
        eps_hat = model_fn(x, labels)
        return -0.5 * beta_t * x - 0.5 * beta_t * (-eps_hat / std)

    return drift


def _other_leaves(y: torch.Tensor, x: torch.Tensor) -> int:
    """How many tensors besides ``x`` that require grad ``y``'s autograd
    graph reaches."""
    seen, stack, n = set(), [y.grad_fn], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        leaf = getattr(node, 'variable', None)      # an AccumulateGrad node
        n += leaf is not None and leaf is not x
        stack.extend(nxt for nxt, _ in node.next_functions)
    return n


def get_drift_and_div_fn(sde: VPSDE, model_fn: Callable) -> Callable:
    """``drift_and_div(x, t, eps) -> (drift, div)``: the drift at (x, t)
    and the Hutchinson estimate sum(eps * (eps^T df/dx)) a sample, both
    detached. ``model_fn``'s parameters must not require grad."""
    drift_fn = get_drift_fn(sde, model_fn)
    checked = False

    def drift_and_div(x: torch.Tensor, t: torch.Tensor, eps: torch.Tensor):
        nonlocal checked
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            drift = drift_fn(x, t)
            if not checked:
                n = _other_leaves(drift, x)
                if n:
                    raise ValueError(f'model_fn reaches {n} tensors that require grad: freeze '
                                     'the model (model.requires_grad_(False)) first')
                checked = True
            (vjp,) = torch.autograd.grad(drift, x, eps)
        return drift.detach(), torch.sum(vjp * eps, dim=tuple(range(1, x.ndim)))

    return drift_and_div


def hutchinson_noise(kind: str, device, seed: int) -> NoiseFn:
    """Draws of one torch.Generator on ``device``: Rademacher (+-1) or
    standard normal."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def noise(name, shape, i=-1, j=0):
        if kind == 'Gaussian':
            return torch.randn(shape, generator=gen, device=device)
        return torch.randint(0, 2, shape, generator=gen, device=device).float() * 2.0 - 1.0
    return noise


def get_likelihood_fn(sde: VPSDE, model_fn: Callable, hutchinson_type: str = 'Rademacher',
                      rtol: float = 1e-5, atol: float = 1e-5, method: str = 'RK45',
                      eps: float = 1e-5, inverse_scaler=None, device='cuda'):
    """Returns ``likelihood_fn(noise, data) -> (bpd, z, nfe)``: data (B, R,
    R, R, C) channels-last (numpy or a tensor), ``noise`` a seed or a noise
    source whose ``noise('hutchinson', shape)`` is the Hutchinson vector;
    the ODE integrated from ``eps`` to T on the host, each evaluation on
    ``device`` (the card unless the caller names another). ``model_fn``'s
    parameters must not require grad (a frozen model)."""
    device = resolve_device(device)
    drift_and_div = get_drift_and_div_fn(sde, model_fn)

    def likelihood_fn(noise: Union[int, NoiseFn], data
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
        if hutchinson_type not in ('Gaussian', 'Rademacher'):
            raise NotImplementedError(f"Hutchinson type {hutchinson_type} unknown.")
        data = np.asarray(torch.as_tensor(data).cpu(), np.float32)
        shape = data.shape
        B = shape[0]
        if not callable(noise):
            noise = hutchinson_noise(hutchinson_type, device, noise)
        epsilon = noise('hutchinson', shape).to(device, torch.float32)

        def ode_func(t, x_flat):
            sample = torch.as_tensor(x_flat[:-B].reshape(shape), dtype=torch.float32,
                                     device=device)
            vec_t = torch.full((B,), t, dtype=torch.float32, device=device)
            drift, div = drift_and_div(sample, vec_t, epsilon)
            return np.concatenate([drift.cpu().numpy().reshape(-1), div.cpu().numpy()], axis=0)

        from scipy import integrate     # here: importing it costs ~2 s of compiling
        init = np.concatenate([data.reshape(-1), np.zeros((B,))], axis=0)
        solution = integrate.solve_ivp(ode_func, (eps, sde.T), init, rtol=rtol, atol=atol,
                                       method=method)
        zp = solution.y[:, -1]
        z = zp[:-B].reshape(shape).astype(np.float32)
        delta_logp = zp[-B:].astype(np.float32)
        bpd = -(sde.prior_logp(z) + delta_logp) / np.log(2) / np.prod(shape[1:])
        offset = 7.0 - (inverse_scaler or (lambda x: x))(-1.0)
        return bpd + offset, z, solution.nfev

    return likelihood_fn
