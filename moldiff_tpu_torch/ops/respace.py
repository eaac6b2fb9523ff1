"""Timestep respacing: run the reverse chain on S << T steps
(a copy of moldiff_tpu/ops/respace.py, which the port may not import).

Both transition families compose exactly under striding, so a respaced
sampler is just new transition objects built from composed betas:

* Gaussian: q(x_t | x_0) depends only on alpha_bar_t, and
  alpha_bar'_i = alpha_bar_{tau_i} holds iff
  1 - beta'_i = prod_{u in (tau_{i-1}, tau_i]} (1 - beta_u).
* Categorical with any fixed prior p: one-step matrices
  Q = beta * 1 p^T + (1 - beta) I form a semigroup,
  Q(b1) @ Q(b2) = Q(1 - (1-b1)(1-b2)) (since p^T 1 = 1), so the strided
  one-step matrix has the same form with the same composed beta as the
  Gaussian case, and the cumulative products land on the original
  q_mats[tau_i].

The denoiser is still conditioned on the original timestep tau_i it was
trained with; only the posterior math uses the respaced index.
``MolDiff.sample(num_steps=S)`` threads that map.
"""
from __future__ import annotations

import numpy as np


def respace_timesteps(num_timesteps: int, num_steps: int,
                      gamma: float = 1.0) -> np.ndarray:
    """Ascending subset of [0, T-1] with ``num_steps`` elements, always
    including 0 (the final denoising step, where both transitions
    special-case to means / log_v0) and T-1 (the prior end).

    ``gamma`` warps the spacing: tau_i ~ (i/(S-1))^gamma * (T-1).
    1.0 = uniform; gamma > 1 concentrates steps near t=0 (late denoising —
    where MolDiff's 'segment' bond schedule does its work and where the
    uniform-respacing quality loss shows first, BASELINE.md); gamma < 1
    concentrates near t=T. Rounding collisions are resolved by bumping to
    the next free timestep, so the subset is always strictly increasing.
    """
    T, S = int(num_timesteps), int(num_steps)
    if not 1 <= S <= T:
        raise ValueError(f"num_steps must be in [1, {T}], got {S}")
    if S == 1:
        return np.array([0], dtype=np.int64)
    frac = (np.arange(S) / (S - 1)) ** float(gamma)
    subset = np.round(frac * (T - 1)).astype(np.int64)
    # enforce strict monotonicity (dense regions of the warp can collide)
    for i in range(1, S):
        if subset[i] <= subset[i - 1]:
            subset[i] = subset[i - 1] + 1
    if subset[-1] > T - 1:  # bumping overflowed: walk back from the top
        subset[-1] = T - 1
        for i in range(S - 2, 0, -1):
            if subset[i] >= subset[i + 1]:
                subset[i] = subset[i + 1] - 1
    if subset[0] != 0 or len(np.unique(subset)) != S or subset[-1] != T - 1:
        raise ValueError(f"respacing {T} -> {S} (gamma={gamma}) failed")
    return subset


def respaced_betas(betas: np.ndarray, subset: np.ndarray) -> np.ndarray:
    """Composed betas for the strided chain:
    beta'_i = 1 - prod_{u in (tau_{i-1}, tau_i]} (1 - beta_u), tau_{-1} = -1.

    Computed in float64 log-space off the cumulative sum so the product over
    hundreds of steps loses no precision.
    """
    betas = np.asarray(betas, dtype=np.float64)
    subset = np.asarray(subset, dtype=np.int64)
    log_alpha_cum = np.concatenate([[0.0], np.cumsum(np.log1p(-betas))])
    # (1-b')_i = alpha_cum[tau_i + 1] / alpha_cum[tau_{i-1} + 1]
    hi = log_alpha_cum[subset + 1]
    lo = np.concatenate([[0.0], hi[:-1]])
    return -np.expm1(hi - lo)
