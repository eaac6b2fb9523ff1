"""Functional NN building blocks on plain nested-dict params
(moldiff_tpu/models/nn.py).

Params keep the JAX layout: ``w`` is ``[in, out]`` and ``y = x @ w``, so
checkpoints load with no transposes. Every function computes in the dtype
of its inputs, as the JAX functions do; LayerNorm statistics are float32.

The ``init_*`` functions build the JAX package's trees with torch
``nn.Linear``'s rule, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for ``w`` and
``b`` (nn.py:21-27), from an explicit ``torch.Generator`` on the device the
tensors go to. ``jax.random`` and torch's generators differ, so a tree
matches JAX's in keys, shapes, dtype and distribution, not in its numbers.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _uniform(generator: torch.Generator, shape: tuple, bound: float, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        -bound, bound, generator=generator)


def init_linear(generator: torch.Generator, din: int, dout: int, bias: bool = True,
                device: "str | torch.device" = "cpu") -> dict:
    """{"w": [din, dout], "b": [dout]} (nn.py:21-27)."""
    bound = 1.0 / math.sqrt(din)
    p = {"w": _uniform(generator, (din, dout), bound, device)}
    if bias:
        p["b"] = _uniform(generator, (dout,), bound, device)
    return p


def init_layernorm(dim: int, device: "str | torch.device" = "cpu") -> dict:
    return {"scale": torch.ones(dim, dtype=torch.float32, device=device),
            "bias": torch.zeros(dim, dtype=torch.float32, device=device)}


def init_mlp(generator: torch.Generator, din: int, dout: int, hidden: int,
             num_layer: int = 2, norm: bool = True, act_last: bool = False,
             device: "str | torch.device" = "cpu") -> dict:
    """Linear(in, h) -> [LN, ReLU] -> ... -> Linear(h, out), optionally with
    a trailing LN + ReLU; an ``ln`` leaf marks "normalize and activate after
    this layer" (nn.py:98-124)."""
    layers = []
    for i in range(num_layer):
        d_in = din if i == 0 else hidden
        d_out = dout if i == num_layer - 1 else hidden
        lp = {"lin": init_linear(generator, d_in, d_out, device=device)}
        if (i < num_layer - 1 or act_last) and norm:
            lp["ln"] = init_layernorm(d_out, device)
        layers.append(lp)
    return {"layers": layers}


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


def mlp_parts(p: dict, parts, sizes) -> torch.Tensor:
    """``mlp`` whose first Linear runs by :func:`linear_parts` over the
    implicit concat of ``parts`` (nn.py:70-82)."""
    first = p["layers"][0]
    x = linear_parts(first["lin"], parts, sizes)
    if "ln" in first:
        x = torch.relu(layernorm(first["ln"], x))
    return mlp({"layers": p["layers"][1:]}, x)


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
