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

Tensor parallelism (the ``model`` axis, parallel/mesh.py
tp_param_sharding): an MLP whose hidden width is split over the axis is a
:class:`ShardedMLP` (the trainer marks the shards it holds, :func:`mark_tp`),
and :func:`mlp` / :func:`mlp_parts` given the axis run it as Megatron's
conjugate pair, written out (parallel/collectives.py):

- the inputs enter layer 0 (column-parallel: its ``w``, ``b`` and ``ln``
  hold this rank's hidden columns) through ``copy_to``: identity forward,
  the gradient all-reduced over the axis backward;
- the LayerNorm between layers normalises over the whole hidden width:
  its mean, then its variance (``jnp.mean``, then ``jnp.var``, as
  :func:`layernorm`), in float32 from partial sums all-reduced over the
  axis; each rank uses a statistic for its own columns only, so the
  gradient that reaches it on one rank is partial, and the all-reduce's
  backward all-reduces too;
- middle layers (replicated) all-gather their input, and the last layer
  takes this rank's columns of theirs back;
- the last layer (row-parallel: ``w`` holds this rank's contracting rows)
  makes partial sums, all-reduced (``reduce_from``: the output is
  replicated, so the backward is the identity), and then adds its
  replicated bias once.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..parallel import collectives


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
    ``concat(parts) @ W == sum_i parts[i] @ W[rows_i]`` (nn.py:39-70). A
    ``w`` with leading axes (an expert bank's ``[E, din, dout]``) splits its
    second-to-last one."""
    w = p["w"]
    assert sum(sizes) == w.shape[-2], (sizes, tuple(w.shape))
    y, off = None, 0
    for x, sz in zip(parts, sizes):
        term = x @ w[..., off:off + sz, :]
        y = term if y is None else y + term
        off += sz
    if "b" in p:
        y = y + p["b"]
    return y


def mlp_parts(p: dict, parts, sizes, tp=None) -> torch.Tensor:
    """``mlp`` whose first Linear runs by :func:`linear_parts` over the
    implicit concat of ``parts`` (nn.py:70-82). ``tp``: the model axis
    (parallel/collectives.py Axis) a :class:`ShardedMLP` is split over."""
    if isinstance(p, ShardedMLP):
        return _mlp_tp(p, parts, sizes, tp)
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


def mlp(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """``tp``: as :func:`mlp_parts`."""
    if isinstance(p, ShardedMLP):
        return _mlp_tp(p, (x,), (x.shape[-1],), tp)
    for lp in p["layers"]:
        x = linear(lp["lin"], x)
        if "ln" in lp:
            x = torch.relu(layernorm(lp["ln"], x))
    return x


class ShardedMLP(dict):
    """An MLP's params (``{"layers": [...]}``) whose hidden width is split
    over the model axis: layer 0's ``lin`` and ``ln`` hold this rank's
    columns, the last layer's ``w`` its contracting rows."""


def mark_tp(tree, places):
    """``tree`` with each MLP whose layer 0 ``w`` is split (in ``places``,
    parallel/mesh.py tp_param_sharding of ``tree``: only an MLP's is)
    made a :class:`ShardedMLP`; leaves are kept."""
    if isinstance(tree, dict):
        out = {k: mark_tp(v, places[k]) for k, v in tree.items()}
        layers = places.get("layers")
        if (isinstance(layers, list) and layers and isinstance(layers[0], dict)
                and "lin" in layers[0] and layers[0]["lin"]["w"].dim is not None):
            return ShardedMLP(out)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(mark_tp(v, q) for v, q in zip(tree, places))
    return tree


def unmark_tp(tree):
    """``tree`` with plain dicts in place of :class:`ShardedMLP`."""
    if isinstance(tree, dict):
        return {k: unmark_tp(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unmark_tp(v) for v in tree)
    return tree


def layernorm_tp(p: dict, x: torch.Tensor, tp, width: int, eps: float = 1e-5) -> torch.Tensor:
    """:func:`layernorm` of a tensor whose last dimension (``width`` in
    all) is split over ``tp``: this rank's columns, ``p`` its slice."""
    xf = x.to(torch.float32)
    mean = collectives.all_reduce(tp, xf.sum(dim=-1, keepdim=True)) / width
    d = xf - mean
    var = collectives.all_reduce(tp, (d * d).sum(dim=-1, keepdim=True)) / width
    y = d * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _mlp_tp(p: ShardedMLP, parts, sizes, tp) -> torch.Tensor:
    """A :class:`ShardedMLP` on ``parts`` (replicated over ``tp``)."""
    if tp is None:
        raise ValueError("a tensor-parallel MLP needs its model axis")
    layers = p["layers"]
    parts = collectives.copy_to(tp, *parts)
    parts = parts if isinstance(parts, tuple) else (parts,)
    first = layers[0]
    x = linear_parts(first["lin"], parts, sizes)
    width = x.shape[-1] * tp.size
    if "ln" in first:
        x = torch.relu(layernorm_tp(first["ln"], x, tp, width))
    if len(layers) > 2:
        x = collectives.gather(tp, x, -1)
        x = mlp({"layers": layers[1:-1]}, x)
        x = collectives.scatter(tp, x, -1)
    last = layers[-1]
    y = collectives.reduce_from(tp, x @ last["lin"]["w"])
    if "b" in last["lin"]:
        y = y + last["lin"]["b"]
    if "ln" in last:
        y = torch.relu(layernorm(last["ln"], y))
    return y


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
