"""Gaussian (DDPM) diffusion transition (moldiff_tpu/ops/gaussian.py).

Schedule constants are computed on the host in float64 and kept as float32
tensors. The noise of every draw is an argument: torch and jax.random give
different numbers for one seed, so a caller that wants one step to match
the JAX package passes the same noise to both.
"""
from __future__ import annotations

import numpy as np
import torch


class GaussianTransition:
    """q(x_t | x_0) = N(sqrt(a_bar_t) x_0, (1 - a_bar_t) I) and its posterior."""

    def __init__(self, betas: np.ndarray, device: "str | torch.device" = "cpu"):
        betas = np.asarray(betas, dtype=np.float64)
        alphas = 1.0 - betas
        alphas_bar = np.cumprod(alphas, axis=0)
        alphas_bar_prev = np.concatenate([[1.0], alphas_bar[:-1]])

        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
        self.num_timesteps = len(betas)
        # posterior q(x_{t-1} | x_0, x_t) coefficients
        self.coef_x0 = f32(np.sqrt(alphas_bar_prev) * betas / (1 - alphas_bar))
        self.coef_xt = f32(np.sqrt(alphas) * (1 - alphas_bar_prev) / (1 - alphas_bar))
        self.std = f32(np.sqrt((1 - alphas_bar_prev) * betas / (1 - alphas_bar)))

    @staticmethod
    def _bcast(coef_t: torch.Tensor, ndim: int) -> torch.Tensor:
        return coef_t.reshape(coef_t.shape + (1,) * (ndim - 1))

    def get_prev_from_recon(self, x_t: torch.Tensor, x_recon: torch.Tensor,
                            t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x_{t-1} = mu + std_t * noise from q(x_{t-1} | x_t, x0=x_recon);
        the posterior mean at t == 0 (gaussian.py:65-77)."""
        nd = x_t.dim()
        mu = self._bcast(self.coef_x0[t], nd) * x_recon + self._bcast(self.coef_xt[t], nd) * x_t
        x_prev = mu + self._bcast(self.std[t], nd) * noise
        return torch.where(self._bcast(t == 0, nd), mu, x_prev)

    def sample_init(self, noise: torch.Tensor) -> torch.Tensor:
        """x_T ~ N(0, I): the prior draw is the noise itself."""
        return noise.to(torch.float32)
