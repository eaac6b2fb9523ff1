"""Functional NN building blocks on plain nested-dict params
(moldiff_tpu/models/nn.py).

Params keep the JAX layout: ``w`` is ``[in, out]`` and ``y = x @ w``, so
checkpoints load with no transposes. Every function computes in the dtype
of its inputs, as the JAX functions do; LayerNorm statistics are float32.
"""
from __future__ import annotations

import numpy as np
import torch


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def linear_parts(p: dict, parts, sizes) -> torch.Tensor:
    """Linear over the implicit ``concat(parts, -1)`` without building it:
    ``concat(parts) @ W == sum_i parts[i] @ W[rows_i]`` (nn.py:39-70)."""
    w = p["w"]
    assert sum(sizes) == w.shape[0], (sizes, tuple(w.shape))
    y, off = None, 0
    for x, sz in zip(parts, sizes):
        term = x @ w[off:off + sz]
        y = term if y is None else y + term
        off += sz
    if "b" in p:
        y = y + p["b"]
    return y


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics, result in ``x``'s dtype."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    for lp in p["layers"]:
        x = linear(lp["lin"], x)
        if "ln" in lp:
            x = torch.relu(layernorm(lp["ln"], x))
    return x


class GaussianSmearing:
    """RBF expansion of scalars (nn.py:124-150): exp- or linear-spaced
    offsets, widths from consecutive offset gaps, inputs clamped to
    [start, stop]."""

    def __init__(self, start: float = 0.0, stop: float = 10.0, num_gaussians: int = 50,
                 type_: str = "exp"):
        self.start = float(start)
        self.stop = float(stop)
        if type_ == "exp":
            offset = np.exp(np.linspace(np.log(start + 1), np.log(stop + 1), num_gaussians)) - 1
        elif type_ == "linear":
            offset = np.linspace(start, stop, num_gaussians)
        else:
            raise NotImplementedError("type_ must be either exp or linear")
        diff = np.diff(offset)
        diff = np.concatenate([diff[:1], diff])
        self.offset = torch.tensor(offset, dtype=torch.float32)
        self.coeff = torch.tensor(-0.5 / diff**2, dtype=torch.float32)
        self._on_device = {}

    def _constants(self, device: torch.device):
        if device not in self._on_device:
            self._on_device[device] = (self.offset.to(device), self.coeff.to(device))
        return self._on_device[device]

    def __call__(self, dist: torch.Tensor) -> torch.Tensor:
        """dist [...] -> [..., num_gaussians] float32."""
        offset, coeff = self._constants(dist.device)
        d = torch.clamp(dist, self.start, self.stop)
        delta = d[..., None] - offset
        return torch.exp(coeff * delta**2)


def safe_distance(rel_vec: torch.Tensor) -> torch.Tensor:
    """Norm over the last axis, 0 (not NaN) where the vector is 0."""
    sq = torch.sum(rel_vec**2, dim=-1)
    positive = sq > 0
    sq_safe = torch.where(positive, sq, torch.ones_like(sq))
    return torch.where(positive, torch.sqrt(sq_safe), torch.zeros_like(sq))
