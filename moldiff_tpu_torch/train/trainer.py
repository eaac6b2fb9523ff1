"""Train and eval steps, EMA and checkpoints (moldiff_tpu/train/trainer.py).

One training step is the JAX package's ``jax.value_and_grad(loss_fn)`` +
optax update + EMA, on one card: the position jitter of
``pos_noise_std``, the model's ``get_loss`` through the kernels (forward
and backward), the global gradient norm before clipping, the optimizer of
train/optim.py, then ``ema <- decay * ema + (1 - decay) * params``. The
model is MolDiff or the BondPredictor: anything with ``init_params``,
``get_loss`` and ``draw_loss_noise``. Its random numbers come in as
:class:`TrainNoise`, so one step can be checked against the JAX package's
given the same noise.

With ``grad_accum`` K > 1 (trainer.py:194-225) the batch is padded with
fully masked graphs to a multiple of K and split into K microbatches on
its leading axis; each has its own noise (drawn one microbatch after
another, as JAX's ``split(key, K)`` gives one key to each); the float32
gradients are summed, divided by K, and the loss terms averaged.

Checkpoints keep the JAX package's pickle layout (trainer.py:372-395):
``config``, float32 numpy ``params`` and ``ema_params``, ``step``,
``scheduler`` (its state_dict), ``key`` None and ``opt_state`` None, so
``moldiff_tpu.train.trainer.load_checkpoint`` and ``Trainer.load_checkpoint``
read them as they read a distribution checkpoint (a fresh optimizer). The
port's own optimizer state goes under ``extra["optimizer"]`` as numpy
arrays, and the port resumes from it.
"""
from __future__ import annotations

import glob
import os
import pickle
import shutil
from typing import Any, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..data.batching import pad_batch_to_multiple
from ..data.loader import BATCH_KEYS
from ..utils.checkpoint import load_checkpoint_numpy, params_to_torch
from .optim import (OptState, Optimizer, get_lr, get_scheduler, global_norm, set_lr,
                    tree_leaves, tree_map, tree_unflatten)

class TrainState(NamedTuple):
    params: Any
    opt_state: OptState
    step: int
    ema_params: Any = None


class TrainNoise(NamedTuple):
    """The random numbers of one train or eval step (of one microbatch)."""
    jitter: Optional[torch.Tensor]   # [B, N, 3] standard normal (pos_noise_std > 0)
    loss: Any                        # the model's: LossNoise or BondLossNoise


def batch_to_device(batch: dict, device: "str | torch.device") -> dict:
    """A loader batch (numpy) -> tensors on ``device``, class indices long."""
    out = {k: torch.from_numpy(np.asarray(batch[k])).to(device) for k in BATCH_KEYS}
    out["node_type"] = out["node_type"].long()
    out["halfedge_type"] = out["halfedge_type"].long()
    return out


def _to_numpy(tree: Any) -> Any:
    return tree_map(lambda x: x.detach().cpu().numpy().astype(np.float32), tree)


def _copy(tree: Any) -> Any:
    return tree_map(lambda x: x.detach().clone(), tree)


class Trainer:
    """Owns the optimizer and scheduler; ``model`` exposes
    ``init_params(generator)``, ``draw_loss_noise(b, n, generator)`` and
    ``get_loss(params, node_type, pos, halfedge_type, node_mask, noise)``
    (MolDiff and BondPredictor do)."""

    def __init__(self, model, train_config: dict):
        self.model = model
        self.config = train_config
        self.grad_accum = int(train_config.get("grad_accum", 1) or 1)
        opt_cfg = dict(train_config["optimizer"])
        opt_cfg.setdefault("max_grad_norm", train_config.get("max_grad_norm", 0.0))
        self.optimizer = Optimizer(opt_cfg)
        self.scheduler = get_scheduler(train_config["scheduler"], base_lr=float(opt_cfg["lr"]))
        self.pos_noise_std = float(train_config.get("pos_noise_std", 0.0))
        self.ema_decay = float(train_config.get("ema_decay", 0.0) or 0.0)

    # -- steps -----------------------------------------------------------------

    def _draw(self, b: int, n: int, generator: torch.Generator) -> TrainNoise:
        jitter = None
        if self.pos_noise_std > 0:
            jitter = torch.randn((b, n, 3), generator=generator, device=self.model.device)
        return TrainNoise(jitter, self.model.draw_loss_noise(b, n, generator))

    def draw_noise(self, batch: dict, generator: torch.Generator) -> TrainNoise:
        """Fresh noise for :meth:`eval_step` on ``batch``, padded to a
        multiple of ``grad_accum``: one TrainNoise for the whole batch."""
        b, n = batch["node_type"].shape
        return self._draw(-(-b // self.grad_accum) * self.grad_accum, n, generator)

    def draw_step_noise(self, batch: dict, generator: torch.Generator) -> List[TrainNoise]:
        """Fresh noise for :meth:`train_step` on ``batch``: one TrainNoise
        per microbatch of the batch padded to a multiple of ``grad_accum``,
        drawn one microbatch after another."""
        b, n = batch["node_type"].shape
        k = self.grad_accum
        return [self._draw(-(-b // k), n, generator) for _ in range(k)]

    def loss_fn(self, params, batch: dict, noise: TrainNoise):
        """(loss, dict of loss terms) with the position jitter applied
        (trainer.py:55-76)."""
        pos = batch["pos"]
        if self.pos_noise_std > 0:
            pos = pos + self.pos_noise_std * noise.jitter
        return self.model.get_loss(params, batch["node_type"], pos, batch["halfedge_type"],
                                   batch["node_mask"], noise.loss)

    def _grads(self, params, batch: dict, noise: TrainNoise):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, aux = self.loss_fn(tree_unflatten(params, leaves), batch, noise)
            grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: v.detach() for k, v in aux.items()}

    def train_step(self, state: TrainState, batch: dict,
                   noise: Union[TrainNoise, Sequence[TrainNoise]]):
        """One optimizer step -> (new state, aux); aux holds the loss terms
        and ``grad_norm``, the global norm before clipping (trainer.py:229).
        ``noise`` holds one TrainNoise per microbatch
        (:meth:`draw_step_noise`); with grad_accum 1 it may be the one
        TrainNoise itself."""
        k = self.grad_accum
        noise = [noise] if isinstance(noise, TrainNoise) else list(noise)
        assert len(noise) == k, (len(noise), k)
        if k == 1:
            grads, aux = self._grads(state.params, batch, noise[0])
        else:
            batch = pad_batch_to_multiple(batch, k)
            m = batch["node_type"].shape[0] // k
            grads, auxs = None, []
            for i, mb_noise in enumerate(noise):
                micro = {key: v[i * m:(i + 1) * m] for key, v in batch.items()}
                g, a = self._grads(state.params, micro, mb_noise)
                grads = g if grads is None else torch._foreach_add(grads, g)
                auxs.append(a)
            grads = torch._foreach_div(grads, float(k))
            aux = {key: torch.stack([a[key] for a in auxs]).mean() for key in auxs[0]}
        aux["grad_norm"] = global_norm(grads)
        grads = tree_unflatten(state.params, grads)
        new_params, opt_state = self.optimizer.update(grads, state.opt_state, state.params)
        ema = state.ema_params
        if self.ema_decay > 0:
            d = self.ema_decay
            ema = tree_unflatten(ema, torch._foreach_add(
                torch._foreach_mul(tree_leaves(ema), d),
                torch._foreach_mul(tree_leaves(new_params), 1.0 - d)))
        return TrainState(new_params, opt_state, state.step + 1, ema), aux

    @torch.no_grad()
    def eval_step(self, params, batch: dict, noise: TrainNoise) -> dict:
        """The loss terms on the whole batch (padded to a multiple of
        grad_accum, as the JAX step pads it)."""
        return self.loss_fn(params, pad_batch_to_multiple(batch, self.grad_accum), noise)[1]

    def scheduler_step(self, state: TrainState, val_metric: float) -> TrainState:
        """The host-side learning-rate update between steps."""
        set_lr(state.opt_state, self.scheduler.step(val_metric, get_lr(state.opt_state)))
        return state

    # -- state and checkpoints -------------------------------------------------

    def init_state(self, generator: torch.Generator) -> TrainState:
        """Fresh params from ``generator``, a fresh optimizer, EMA a copy of
        the params (trainer.py:274-282)."""
        return self.init_from_params(self.model.init_params(generator))

    def init_from_params(self, params: Any, step: int = 0, ema_params: Any = None) -> TrainState:
        """A state with a fresh optimizer; EMA seeded from a copy of the
        params unless given (trainer.py:327-333)."""
        ema = None
        if self.ema_decay > 0:
            ema = _copy(params) if ema_params is None else ema_params
        return TrainState(params, self.optimizer.init(params), int(step), ema)

    def load_checkpoint(self, path: str, device: "str | torch.device") -> TrainState:
        """Trainer.load_checkpoint (trainer.py:318-350): a distribution
        checkpoint (``opt_state`` None, no port optimizer under ``extra``)
        starts a fresh optimizer; a checkpoint the port wrote resumes its
        moments and learning rate."""
        blob = load_checkpoint_numpy(path)
        params = params_to_torch(blob["params"], device)
        ema = blob.get("ema_params")
        ema = params_to_torch(ema, device) if ema is not None else None
        state = self.init_from_params(params, blob.get("step", 0) or 0, ema)
        saved = (blob.get("extra") or {}).get("optimizer")
        if saved is not None:
            state.opt_state.count = int(saved["count"])
            state.opt_state.mu = params_to_torch(saved["mu"], device)
            state.opt_state.nu = params_to_torch(saved["nu"], device)
            state.opt_state.lr = float(saved["lr"])
        if blob.get("scheduler") is not None:
            self.scheduler.load_state_dict(blob["scheduler"])
        return state

    def save_checkpoint(self, path: str, state: TrainState, config: Any,
                        extra: Optional[dict] = None) -> None:
        save_checkpoint(path, state, config, scheduler=self.scheduler, extra=extra)


def checkpoint_blob(state: TrainState, config: Any, scheduler=None,
                    extra: Optional[dict] = None) -> dict:
    """A host copy of ``state`` in the JAX package's pickle layout
    (trainer.py:372-395), the port's optimizer state under
    ``extra["optimizer"]``: later updates of the state leave it as it is."""
    opt = state.opt_state
    extra = dict(extra or {})
    extra["optimizer"] = {"count": int(opt.count), "mu": _to_numpy(opt.mu),
                          "nu": _to_numpy(opt.nu), "lr": float(opt.lr)}
    return {
        "config": config.to_dict() if hasattr(config, "to_dict") else config,
        "params": _to_numpy(state.params),
        "opt_state": None,
        "step": int(state.step),
        "scheduler": scheduler.state_dict() if scheduler is not None else None,
        "key": None,
        "extra": extra,
        "ema_params": _to_numpy(state.ema_params) if state.ema_params is not None else None,
    }


def write_checkpoint(path: str, blob: dict) -> None:
    """Pickle ``blob`` to ``path`` through a temporary file and an atomic
    rename: ``path`` is never a partial file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(path: str, state: TrainState, config: Any, scheduler=None,
                    extra: Optional[dict] = None) -> None:
    write_checkpoint(path, checkpoint_blob(state, config, scheduler, extra))


def prune_checkpoints(ckpt_dir: str, keep: int) -> List[str]:
    """Keep only the ``keep`` newest numeric checkpoints (``<it>.ckpt``)
    under ``ckpt_dir``; other names (best.ckpt) are never touched, and
    ``keep`` <= 0 keeps all (trainer.py:398-421). Returns the removed
    paths."""
    if keep <= 0:
        return []
    numeric = []
    for p in glob.glob(os.path.join(ckpt_dir, "*.ckpt")):
        stem = os.path.splitext(os.path.basename(p))[0]
        if stem.isdigit():
            numeric.append((int(stem), p))
    numeric.sort()
    removed = []
    for _, p in numeric[:-keep]:
        if os.path.isdir(p):
            shutil.rmtree(p)
        else:
            os.remove(p)
        removed.append(p)
    return removed
