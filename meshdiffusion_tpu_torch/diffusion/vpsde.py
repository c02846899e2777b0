"""Variance-preserving SDE with precomputed discrete tables.

Counterpart of ``meshdiffusion_tpu/diffusion/vpsde.py`` (reference
``lib/diffusion/sde_lib.py:176-233``, a VPSDE with a linear beta
schedule). The per-step tables are built on the host in float64 with numpy
and cast to float32, exactly as the JAX package builds them, so the two
packages' tables are bit-equal.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _build_tables(beta_0: float, beta_1: float, N: int) -> dict:
    betas = np.linspace(beta_0 / N, beta_1 / N, N, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    return {
        'discrete_betas': betas.astype(np.float32),
        'alphas': alphas.astype(np.float32),
        'alphas_cumprod': alphas_cumprod.astype(np.float32),
        'sqrt_alphas_cumprod': np.sqrt(alphas_cumprod).astype(np.float32),
        'sqrt_1m_alphas_cumprod': np.sqrt(1.0 - alphas_cumprod).astype(np.float32),
    }


@dataclasses.dataclass(frozen=True)
class VPSDE:
    """Variance-preserving SDE, beta(t) linear in [beta_0, beta_1]; the
    discrete tables follow the DDPM convention
    ``discrete_betas = linspace(beta_min/N, beta_max/N, N)``."""

    beta_min: float = 0.1
    beta_max: float = 20.0
    N: int = 1000

    @property
    def beta_0(self) -> float:
        return self.beta_min

    @property
    def beta_1(self) -> float:
        return self.beta_max

    @property
    def T(self) -> float:
        return 1.0

    def _tables(self) -> dict:
        return _build_tables(self.beta_min, self.beta_max, self.N)

    @property
    def discrete_betas(self) -> np.ndarray:
        return self._tables()['discrete_betas']

    @property
    def alphas(self) -> np.ndarray:
        return self._tables()['alphas']

    @property
    def alphas_cumprod(self) -> np.ndarray:
        return self._tables()['alphas_cumprod']

    @property
    def sqrt_alphas_cumprod(self) -> np.ndarray:
        return self._tables()['sqrt_alphas_cumprod']

    @property
    def sqrt_1m_alphas_cumprod(self) -> np.ndarray:
        return self._tables()['sqrt_1m_alphas_cumprod']

    def marginal_coeffs(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean coefficient, std) of p_t(x | x_0) as (B,) vectors."""
        log_mean_coeff = (-0.25 * t ** 2 * (self.beta_1 - self.beta_0)
                          - 0.5 * t * self.beta_0)
        return torch.exp(log_mean_coeff), torch.sqrt(1.0 - torch.exp(2.0 * log_mean_coeff))

    def marginal_prob(self, x: torch.Tensor, t: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and std of p_t(x | x_0) (reference sde_lib.py:210-214)."""
        coeff, std = self.marginal_coeffs(t)
        return coeff.reshape(coeff.shape + (1,) * (x.ndim - 1)) * x, std

    def prior_logp(self, z: np.ndarray) -> np.ndarray:
        """log N(z; 0, I) of each sample of a float32 batch (reference
        sde_lib.py:216-219)."""
        n = float(np.prod(z.shape[1:]))
        return -n / 2.0 * np.log(2 * np.pi) - np.sum(z ** 2, axis=tuple(range(1, z.ndim))) / 2.0

    def timesteps(self, eps: float = 1e-3) -> np.ndarray:
        """The reverse-time grid linspace(T, eps, N) used by the samplers."""
        return np.linspace(self.T, eps, self.N, dtype=np.float64).astype(np.float32)
