"""The VP SDE's discrete schedule and the masked ancestral update, written
from score_sde's ``sde_lib.VPSDE`` and ``AncestralSamplingPredictor``
(MeshDiffusion's sampler): betas = linspace(beta_min/N, beta_max/N, N),
timesteps linspace(1, eps, N) in float32, label t*(N-1), table index
long(t*(N-1)), score = -eps_hat / sqrt(1 - alphas_cumprod[index]),
x_mean = (x + beta*score) / sqrt(1 - beta), x = x_mean + sqrt(beta)*z, and
the grid mask multiplied into both."""

from __future__ import annotations

from typing import Tuple

import torch


class Schedule:
    def __init__(self, beta_min: float, beta_max: float, N: int, eps: float = 1e-3):
        self.N = N
        self.betas = torch.linspace(beta_min / N, beta_max / N, N, dtype=torch.float64)
        self.sqrt_1m_acp = torch.sqrt(1.0 - torch.cumprod(1.0 - self.betas, 0))
        self.t = torch.linspace(1.0, eps, N, dtype=torch.float32)

    def step(self, i: int) -> Tuple[float, float, float]:
        """(label, beta, std) of reverse step i."""
        label = self.t[i] * (self.N - 1)
        idx = int(label.long())
        return float(label), float(self.betas[idx]), float(self.sqrt_1m_acp[idx])


def ancestral_update(x: torch.Tensor, eps_hat: torch.Tensor, noise: torch.Tensor,
                     mask: torch.Tensor, beta: float, std: float,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x after one masked ancestral step, computed in ``dtype``."""
    x, eps_hat, noise, mask = (t.to(dtype) for t in (x, eps_hat, noise, mask))
    score = -eps_hat / std
    x_mean = (x + beta * score) / (1.0 - beta) ** 0.5 * mask
    return ((x_mean + beta ** 0.5 * noise) * mask).float()
