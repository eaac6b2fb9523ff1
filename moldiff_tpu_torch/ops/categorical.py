"""Categorical (D3PM) diffusion transition with a chosen prior
(moldiff_tpu/ops/categorical.py).

State is ``[B, M, K]`` log-probabilities with per-graph timesteps ``t [B]``.
Transition matrices are built on the host in float64 and kept as float32.
Random draws take their uniform noise as an argument (Gumbel-max), so one
step can be checked against the JAX package given the same uniforms.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-30
LOG_MIN = -32.0


def index_to_log_onehot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """int [..] -> log one-hot [.., K] with log(0) clamped to log(1e-30)."""
    onehot = torch.nn.functional.one_hot(x.long(), num_classes).to(torch.float32)
    return torch.log(torch.clamp(onehot, min=EPS))


def log_sample_categorical(logits: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
    """Gumbel-max class draw from log-probs, given U(0,1) noise of the same
    shape (categorical.py:33-38)."""
    gumbel = -torch.log(-torch.log(uniform + EPS) + EPS)
    return torch.argmax(gumbel + logits, dim=-1)


def _clamped_log(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.log(x + EPS), min=LOG_MIN)


class CategoricalTransition:
    """q(v_t | v_{t-1}) = Cat(beta_t * prior + (1 - beta_t) * onehot(v_{t-1}))
    with the ``absorb`` / ``tomask`` / uniform / custom priors of
    categorical.py:61-84."""

    def __init__(self, betas: np.ndarray, num_classes: int, init_prob=None,
                 device: "str | torch.device" = "cpu"):
        betas = np.asarray(betas, dtype=np.float64)
        self.num_classes = num_classes
        self.num_timesteps = len(betas)

        if init_prob is None or (isinstance(init_prob, str) and init_prob == "uniform"):
            prior = np.ones(num_classes) / num_classes
        elif isinstance(init_prob, str) and init_prob == "absorb":
            prior = 0.01 * np.ones(num_classes)
            prior[0] = 1.0
            prior = prior / prior.sum()
        elif isinstance(init_prob, str) and init_prob == "tomask":
            prior = 0.001 * np.ones(num_classes)
            prior[-1] = 1.0
            prior = prior / prior.sum()
        elif isinstance(init_prob, str):
            raise ValueError(f"unknown init_prob: {init_prob}")
        else:
            prior = np.asarray(init_prob, dtype=np.float64)
            prior = prior / prior.sum()

        eye = np.eye(num_classes)
        ones_prior = np.repeat(prior[None, :], num_classes, axis=0)
        q_one_step = (
            betas[:, None, None] * ones_prior[None] + (1.0 - betas)[:, None, None] * eye[None]
        )
        q_mats = np.empty_like(q_one_step)
        acc = q_one_step[0]
        q_mats[0] = acc
        for t in range(1, self.num_timesteps):
            acc = acc @ q_one_step[t]
            q_mats[t] = acc

        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
        self.alphas_bar = f32(np.cumprod(1.0 - betas))
        self.q_mats = f32(q_mats)
        self.transpose_q_onestep_mats = f32(np.transpose(q_one_step, (0, 2, 1)))
        self.init_prob = f32(prior)
        self.log_prior = torch.clamp(torch.log(self.init_prob + EPS), min=LOG_MIN)

    def onehot_encode(self, v: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.one_hot(v.long(), self.num_classes).to(torch.float32)

    def q_v_posterior(self, log_v0: torch.Tensor, log_vt: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
        """log q(v_{t-1} | v_t, v_0) with soft v0 probabilities (the
        ``v0_prob=True`` path, categorical.py:160-192); log_v0 at t == 0.
        The K x K contractions run in float32 (JAX: Precision.HIGHEST)."""
        t_minus_1 = torch.clamp(t - 1, min=0)
        fact1 = torch.einsum("bmj,bjk->bmk", torch.exp(log_vt),
                             self.transpose_q_onestep_mats[t])
        fact2 = torch.einsum("bmj,bjk->bmk", torch.exp(log_v0), self.q_mats[t_minus_1])
        out = _clamped_log(fact1) + _clamped_log(fact2)
        out = out - torch.logsumexp(out, dim=-1, keepdim=True)
        t_is_zero = (t == 0).reshape(t.shape + (1,) * (log_v0.dim() - 1))
        return torch.where(t_is_zero, log_v0, out)

    def sample_init(self, shape_prefix, uniform: torch.Tensor):
        """Draw v_T from the prior given uniforms of shape
        ``shape_prefix + (K,)``. Returns (classes, one-hot, log one-hot)."""
        logits = self.log_prior.expand(tuple(shape_prefix) + (self.num_classes,))
        init_types = log_sample_categorical(logits, uniform)
        return (init_types, self.onehot_encode(init_types),
                index_to_log_onehot(init_types, self.num_classes))
