"""The optimizer and the learning-rate schedulers (moldiff_tpu/train/optim.py).

The JAX package builds an optax chain: clip-by-global-norm, then adam or
adamw, with the learning rate injected into the optimizer state so the
host-side schedulers can change it between steps. The card has no optax,
so :class:`Optimizer` is that chain written out in PyTorch, op for op
(the clip as one multiply, which differs from optax's divide-then-multiply
by a float32 rounding):

  clip:  g <- g                       if |g| < max_norm
         g <- g * (max_norm / |g|)    otherwise     (|g|: the global norm)
  adam:  mu <- (1 - b1) g + b1 mu,  nu <- (1 - b2) g^2 + b2 nu,  count += 1
         u  <- (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
  adamw: u  <- u + weight_decay * p                 (after adam's scaling)
  step:  p  <- p + (-lr) u

with eps = 1e-8 and float32 moments, as optax's defaults. The schedulers
are copies of the JAX package's, which use no JAX.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List

import torch

from ..utils.tree import tree_leaves, tree_map, tree_unflatten


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (optax), as
    the norm of the leaves' norms: a few launches for any number of leaves."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


@dataclass
class OptState:
    """adam's step count and moments (trees of the params' structure) and
    the injected learning rate."""
    count: int
    mu: Any
    nu: Any
    lr: float


class Optimizer:
    """clip-by-global-norm -> adam / adamw -> learning rate, to optax's
    semantics (optim.py:24-56)."""

    def __init__(self, config: dict):
        self.type = config["type"]
        if self.type not in ("adam", "adamw"):
            raise NotImplementedError(f"optimizer {self.type}")
        self.lr = float(config["lr"])
        self.b1 = float(config.get("beta1", 0.9))
        self.b2 = float(config.get("beta2", 0.999))
        self.weight_decay = float(config.get("weight_decay", 0.0)) if self.type == "adamw" else 0.0
        self.max_grad_norm = float(config.get("max_grad_norm", 0.0))
        self.eps = 1e-8

    def init(self, params: Any) -> OptState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return OptState(0, tree_map(zeros, params), tree_map(zeros, params), self.lr)

    @torch.no_grad()
    def update(self, grads: Any, state: OptState, params: Any,
               g_norm: "torch.Tensor | None" = None):
        """One step -> (new params, new state); ``grads`` has the params'
        structure. Each line is one multi-tensor op over every leaf, in
        optax's order of roundings; the clip stays on the card (no host
        sync): its factor is 1 where optax keeps the gradient. ``g_norm``:
        the gradient's global norm when ``grads`` holds only this rank's
        shards of it (FSDP)."""
        g, p = tree_leaves(grads), tree_leaves(params)
        if self.max_grad_norm > 0:
            if g_norm is None:
                g_norm = global_norm(g)
            factor = torch.where(g_norm < self.max_grad_norm, torch.ones_like(g_norm),
                                 self.max_grad_norm / g_norm)
            g = torch._foreach_mul(g, factor)
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul(tree_leaves(state.mu), b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                torch._foreach_mul(tree_leaves(state.nu), b2))
        count = state.count + 1
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        c1 = float(1 - f32(b1) ** count)
        c2 = float(1 - f32(b2) ** count)
        neg_lr = -float(f32(state.lr))
        u = torch._foreach_div(torch._foreach_div(mu, c1), torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(nu, c2)), self.eps))
        if self.weight_decay:
            u = torch._foreach_add(u, torch._foreach_mul(p, self.weight_decay))
        new_params = torch._foreach_add(p, torch._foreach_mul(u, neg_lr))
        return (tree_unflatten(params, new_params),
                OptState(count, tree_unflatten(params, mu), tree_unflatten(params, nu), state.lr))


def get_lr(state: OptState) -> float:
    return float(state.lr)


def set_lr(state: OptState, lr: float) -> OptState:
    """The state with a new injected learning rate (in place, as the JAX
    package's set_lr mutates the optax state)."""
    state.lr = float(lr)
    return state


class PlateauScheduler:
    """ReduceLROnPlateau (optim.py:68-100): stepped with a validation loss;
    multiplies lr by ``factor`` after ``patience`` consecutive steps without
    improvement, floored at ``min_lr``."""

    def __init__(self, factor: float = 0.8, patience: int = 10, min_lr: float = 1e-5):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = math.inf
        self.num_bad = 0

    def step(self, metric: float, lr: float) -> float:
        if metric < self.best:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            return max(lr * self.factor, self.min_lr)
        return lr

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.best = d["best"]
        self.num_bad = d["num_bad"]

    def reset(self) -> None:
        self.best = math.inf
        self.num_bad = 0


class WarmupPlateauScheduler(PlateauScheduler):
    """A linear warmup over ``total_epoch`` validation steps, then plateau
    (optim.py:103-140)."""

    def __init__(self, base_lr: float, multiplier: float = 1.0, total_epoch: int = 1,
                 factor: float = 0.8, patience: int = 10, min_lr: float = 1e-5):
        super().__init__(factor, patience, min_lr)
        self.base_lr = base_lr
        self.multiplier = multiplier
        self.total_epoch = total_epoch
        self.epoch = 0

    def step(self, metric: float, lr: float) -> float:
        self.epoch += 1
        if self.epoch <= self.total_epoch:
            frac = self.epoch / self.total_epoch
            if self.multiplier == 1.0:
                return self.base_lr * frac
            return self.base_lr * ((self.multiplier - 1.0) * frac + 1.0)
        return super().step(metric, lr)

    def state_dict(self) -> dict:
        d = super().state_dict()
        d["epoch"] = self.epoch
        return d

    def load_state_dict(self, d: dict) -> None:
        super().load_state_dict(d)
        self.epoch = d["epoch"]

    def reset(self) -> None:
        super().reset()
        self.epoch = 0


class ExpMinScheduler:
    """lr <- max(lr * factor, min_lr) each step, from step ``milestone``
    on (optim.py:143-166)."""

    def __init__(self, factor: float, min_lr: float, milestone: int = 0):
        self.factor = factor
        self.min_lr = min_lr
        self.milestone = milestone
        self.epoch = 0

    def step(self, metric: float, lr: float) -> float:
        self.epoch += 1
        if self.epoch < self.milestone:
            return lr
        return max(lr * self.factor, self.min_lr)

    def state_dict(self) -> dict:
        return {"epoch": self.epoch}

    def load_state_dict(self, d: dict) -> None:
        self.epoch = d["epoch"]

    def reset(self) -> None:
        self.epoch = 0


def get_scheduler(config: dict, base_lr: float):
    """Scheduler from a ``train.scheduler`` config node (optim.py:169-200)."""
    stype = config["type"]
    if stype == "plateau":
        return PlateauScheduler(factor=float(config["factor"]), patience=int(config["patience"]),
                                min_lr=float(config.get("min_lr", 0.0)))
    if stype == "warmup_plateau":
        return WarmupPlateauScheduler(
            base_lr=base_lr, multiplier=float(config.get("multiplier", 1.0)),
            total_epoch=int(config["total_epoch"]), factor=float(config["factor"]),
            patience=int(config["patience"]), min_lr=float(config.get("min_lr", 0.0)))
    if stype == "expmin":
        return ExpMinScheduler(factor=float(config["factor"]), min_lr=float(config["min_lr"]))
    if stype == "expmin_milestone":
        return ExpMinScheduler(factor=float(config["factor"]), min_lr=float(config["min_lr"]),
                               milestone=int(config["milestone"]))
    raise NotImplementedError(f"scheduler {stype}")
