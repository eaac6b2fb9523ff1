"""Diffusion beta/alpha schedules.

Host-side (numpy, float64) precomputation of noise schedules. The resulting
arrays are closed over by jitted device functions as constants.

Behavioral parity with the reference implementation
(`reference/models/diffusion.py:95-192`): supports quad / linear /
const / jsd / sigmoid / cosine / advance / segment schedules, where
``advance`` is the sigmoid-shaped alpha-bar curve and ``segment`` is the
piecewise-advance schedule used for MolDiff's decoupled bond diffusion.
"""
from __future__ import annotations

import numpy as np


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (np.exp(-x) + 1.0)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule (reference models/diffusion.py:97)."""
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def advance_schedule(
    timesteps: int,
    scale_start: float,
    scale_end: float,
    width: float,
    return_alphas_bar: bool = False,
):
    """Sigmoid-shaped alpha-bar schedule (reference models/diffusion.py:110).

    alpha_bar(t) interpolates from ``scale_start`` down to ``scale_end``
    following a sigmoid of sharpness ``width`` over t in [-1, 1].
    """
    k = width
    A0, A1 = scale_end, scale_start
    a = (A0 - A1) / (_sigmoid(-k) - _sigmoid(k))
    b = 0.5 * (A0 + A1 - a)

    x = np.linspace(-1, 1, timesteps)
    alphas_cumprod = a * _sigmoid(-k * x) + b

    alphas = np.zeros_like(alphas_cumprod)
    alphas[0] = alphas_cumprod[0]
    alphas[1:] = alphas_cumprod[1:] / alphas_cumprod[:-1]
    betas = np.clip(1 - alphas, 0, 1)
    if return_alphas_bar:
        return betas, alphas_cumprod
    return betas


def segment_schedule(timesteps: int, time_segment, segment_diff) -> np.ndarray:
    """Piecewise-advance schedule (reference models/diffusion.py:133).

    Each segment i spans ``time_segment[i]`` steps with its own advance
    parameters; the per-segment alpha-bar curves are chained by dropping the
    first point of each segment and re-deriving alphas from the concatenated
    alpha-bar sequence. This is the decoupled *bond* schedule: bonds decay
    fast in segment one, slowly in segment two.
    """
    assert np.sum(time_segment) == timesteps, (time_segment, timesteps)
    alphas_cumprod = []
    for seg_len, params in zip(time_segment, segment_diff):
        _, alphas_this = advance_schedule(
            seg_len + 1, **params, return_alphas_bar=True
        )
        alphas_cumprod.extend(alphas_this[1:])
    alphas_cumprod = np.array(alphas_cumprod)

    alphas = np.zeros_like(alphas_cumprod)
    alphas[0] = alphas_cumprod[0]
    alphas[1:] = alphas_cumprod[1:] / alphas_cumprod[:-1]
    return np.clip(1 - alphas, 0, 1)


def get_beta_schedule(beta_schedule: str, num_timesteps: int, **kwargs) -> np.ndarray:
    """Schedule dispatch (reference models/diffusion.py:153-192)."""
    if beta_schedule == "quad":
        betas = (
            np.linspace(
                kwargs["beta_start"] ** 0.5,
                kwargs["beta_end"] ** 0.5,
                num_timesteps,
                dtype=np.float64,
            )
            ** 2
        )
    elif beta_schedule == "linear":
        betas = np.linspace(
            kwargs["beta_start"], kwargs["beta_end"], num_timesteps, dtype=np.float64
        )
    elif beta_schedule == "const":
        betas = kwargs["beta_end"] * np.ones(num_timesteps, dtype=np.float64)
    elif beta_schedule == "jsd":
        betas = 1.0 / np.linspace(num_timesteps, 1, num_timesteps, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        s = kwargs.get("s", 6)
        betas = np.linspace(-s, s, num_timesteps)
        betas = (
            _sigmoid(betas) * (kwargs["beta_end"] - kwargs["beta_start"])
            + kwargs["beta_start"]
        )
    elif beta_schedule == "cosine":
        betas = cosine_beta_schedule(num_timesteps, s=kwargs.get("s", 0.008))
    elif beta_schedule == "advance":
        betas = advance_schedule(
            num_timesteps,
            scale_start=kwargs.get("scale_start", 0.999),
            scale_end=kwargs.get("scale_end", 0.001),
            width=kwargs.get("width", 2),
        )
    elif beta_schedule == "segment":
        betas = segment_schedule(
            num_timesteps, kwargs["time_segment"], kwargs["segment_diff"]
        )
    else:
        raise NotImplementedError(beta_schedule)
    assert betas.shape == (num_timesteps,)
    return betas
