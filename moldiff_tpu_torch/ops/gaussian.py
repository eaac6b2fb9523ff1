"""Gaussian (DDPM) diffusion transition (moldiff_tpu/ops/gaussian.py).

Schedule constants are computed on the host in float64 and kept as float32
tensors. The noise of every draw is an argument: torch and jax.random give
different numbers for one seed, so a caller that wants one step to match
the JAX package passes the same noise to both.

With ``num_classes`` set the transition is the continuous categorical
space's (gaussian.py:23-70): ``add_noise`` takes class indices, one-hot
encodes them and divides by ``scaling`` before perturbing.
"""
from __future__ import annotations

import numpy as np
import torch


class GaussianTransition:
    """q(x_t | x_0) = N(sqrt(a_bar_t) x_0, (1 - a_bar_t) I) and its posterior."""

    def __init__(self, betas: np.ndarray, device: "str | torch.device" = "cpu",
                 num_classes: "int | None" = None, scaling: float = 1.0):
        self.num_classes = num_classes
        self.scaling = float(scaling)
        betas = np.asarray(betas, dtype=np.float64)
        alphas = 1.0 - betas
        alphas_bar = np.cumprod(alphas, axis=0)
        alphas_bar_prev = np.concatenate([[1.0], alphas_bar[:-1]])

        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
        self.num_timesteps = len(betas)
        self.alphas_bar = f32(alphas_bar)
        self.alphas_bar_prev = f32(alphas_bar_prev)
        # posterior q(x_{t-1} | x_0, x_t) coefficients
        self.coef_x0 = f32(np.sqrt(alphas_bar_prev) * betas / (1 - alphas_bar))
        self.coef_xt = f32(np.sqrt(alphas) * (1 - alphas_bar_prev) / (1 - alphas_bar))
        self.std = f32(np.sqrt((1 - alphas_bar_prev) * betas / (1 - alphas_bar)))

    @staticmethod
    def _bcast(coef_t: torch.Tensor, ndim: int) -> torch.Tensor:
        return coef_t.reshape(coef_t.shape + (1,) * (ndim - 1))

    def add_noise(self, x: torch.Tensor, t: torch.Tensor, noise: torch.Tensor):
        """x_t = sqrt(a_bar_t) x + sqrt(1 - a_bar_t) noise, a draw from
        q(x_t | x_0) given standard-normal noise (gaussian.py:55-72). With
        ``num_classes`` set, x holds class indices [B, ...] and noise is
        [B, ..., num_classes]; returns (x_t, x0), x0 the one-hots divided by
        ``scaling``."""
        if self.num_classes is not None:
            x0 = torch.nn.functional.one_hot(x.long(), self.num_classes).float() / self.scaling
            a_bar = self._bcast(self.alphas_bar[t], x0.dim())
            return torch.sqrt(a_bar) * x0 + torch.sqrt(1.0 - a_bar) * noise, x0
        a_bar = self._bcast(self.alphas_bar[t], x.dim())
        return torch.sqrt(a_bar) * x + torch.sqrt(1.0 - a_bar) * noise

    def get_prev_from_recon(self, x_t: torch.Tensor, x_recon: torch.Tensor,
                            t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x_{t-1} = mu + std_t * noise from q(x_{t-1} | x_t, x0=x_recon);
        the posterior mean at t == 0 (gaussian.py:65-77)."""
        nd = x_t.dim()
        mu = self._bcast(self.coef_x0[t], nd) * x_recon + self._bcast(self.coef_xt[t], nd) * x_t
        x_prev = mu + self._bcast(self.std[t], nd) * noise
        return torch.where(self._bcast(t == 0, nd), mu, x_prev)

    def ddim_prev(self, x_t: torch.Tensor, x_recon: torch.Tensor, t: torch.Tensor,
                  noise: torch.Tensor, eta: float = 0.0) -> torch.Tensor:
        """DDIM step from the x0 prediction given standard-normal noise
        (gaussian.py:87-113): ``eta`` 0 is deterministic, 1 the DDPM
        posterior's mean and std. At t == 0 alphas_bar_prev is 1, so the
        noise scale and the eps coefficient vanish and the step returns
        x_recon."""
        nd = x_t.dim()
        a_t = self._bcast(self.alphas_bar[t], nd)
        a_prev = self._bcast(self.alphas_bar_prev[t], nd)
        eps = (x_t - torch.sqrt(a_t) * x_recon) / torch.sqrt(1.0 - a_t)
        sigma = eta * torch.sqrt(torch.clamp((1.0 - a_prev) / (1.0 - a_t), min=0.0)
                                 * torch.clamp(1.0 - a_t / a_prev, min=0.0))
        mean = (torch.sqrt(a_prev) * x_recon
                + torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0)) * eps)
        return mean + sigma * noise

    def sample_init(self, noise: torch.Tensor) -> torch.Tensor:
        """x_T ~ N(0, I): the prior draw is the noise itself."""
        return noise.to(torch.float32)
