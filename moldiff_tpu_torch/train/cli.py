"""Training the MolDiff denoiser (scripts/train_drug3d.py), and the loop
that it shares with the bond predictor's trainer (bond_cli.py).

  python -m moldiff_tpu_torch.train --config configs/train/train_full_synthetic_xl_scratch.yml \
      [--resume CKPT [--reset_ema] [--reset_optim] [--override_lr LR]] [--max_iters N] \
      [--profile_at IT] [--corpus_mols M] [--device cuda|cpu] [--logdir ./logs_torch] \
      [--name NAME]

Without ``--resume`` the run starts from fresh params drawn from
``train.seed`` (Trainer.init_state: EMA a copy of them, a fresh
optimizer). The iteration loop is the JAX CLI's: ``--max_iters`` is
absolute (a resume at step 300000 with ``--max_iters 300012`` takes 12
steps); a log line every 100 iterations and at the run's first;
validation every ``train.val_freq`` iterations over at most
``train.val_batches`` batches, whose mean loss steps the scheduler; a
checkpoint every ``train.ckpt_freq`` iterations and at the end, under
``<logdir>/<name>_<time>/checkpoints/<it>.ckpt``, after which only the
``train.keep_ckpts`` newest numeric checkpoints stay (0 or absent: all).
With ``train.ckpt_async`` the checkpoints are written on a background
thread (checkpoint_async.py), joined (and the directory pruned once more)
before the run returns. ``--override_lr`` replaces the learning rate a
resume restored; ``--profile_at N`` writes a torch.profiler trace of
iteration N to ``<log dir>/profile/trace_it<N>.json`` (the JAX CLI's
``jax.profiler`` trace). Unlike the JAX CLI, a failing step raises instead
of being skipped: on the card a skipped step would hide a kernel fault.

The training data is the config's ``dataset.root`` corpus, generated in
memory (data/dataset.py make_corpus): its first ``--corpus_mols``
molecules, split 80/10/10. :func:`run` is the same path for a caller that
holds the config as a dict (the card machine has no PyYAML).
"""
from __future__ import annotations

import argparse
import os
import random
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.dataset import make_corpus
from ..data.featurize import featurizer_from_config
from ..data.loader import BucketedLoader
from ..models.moldiff import MolDiff, resolve_device
from ..ops import kernels
from ..utils.config import Config
from .checkpoint_async import AsyncCheckpointer
from .optim import get_lr, set_lr, tree_leaves, tree_map
from .trainer import Trainer, batch_to_device, prune_checkpoints

DEFAULT_CORPUS_MOLS = 2000


def _new_log_dir(root: str, prefix: str) -> str:
    log_dir = os.path.join(root, f"{prefix}_{time.strftime('%Y_%m_%d__%H_%M_%S')}")
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def _profiled(fn, path: str):
    """fn() under torch.profiler (the card's activity too on a card), its
    trace written to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with profile(activities=activities) as prof:
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    return out


def fit(config: Config, model, featurizer, device: torch.device, resume: Optional[str],
        logdir: str, name: str, max_iters: Optional[int], corpus_mols: int,
        subsets: Optional[Dict[str, list]], log: Callable[[str], None],
        reset_ema: bool = False, reset_optim: bool = False,
        override_lr: Optional[float] = None, profile_at: int = 0) -> dict:
    """The training loop of both CLIs for ``model`` (MolDiff or
    BondPredictor) -> summary: the log dir, one record per train step
    (iteration, bucket, loss terms, grad norm, lr, seconds, kernel
    launches), the validation losses, the checkpoints written, and the
    final state and trainer."""
    train_cfg = config.train
    if train_cfg.get("ckpt_sharded", False):
        raise NotImplementedError("sharded checkpoints (train.ckpt_sharded) are not ported yet")
    seed = int(train_cfg.seed)
    random.seed(seed)
    np.random.seed(seed)
    log_dir = _new_log_dir(logdir, name)
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)

    trainer = Trainer(model, train_cfg)
    # one stream from the seed: the initial params (when not resumed), then
    # every step's noise
    gen = torch.Generator(device=device).manual_seed(seed)
    if resume:
        state = trainer.load_checkpoint(resume, device)
        log(f"resumed from {resume} at step {state.step} | device {device}")
        if reset_ema and state.ema_params is not None:
            state = state._replace(ema_params=tree_map(lambda p: p.detach().clone(),
                                                       state.params))
            log("EMA re-seeded from restored params (--reset_ema)")
        if reset_optim:
            state = state._replace(opt_state=trainer.optimizer.init(state.params))
            trainer.scheduler.reset()
            log("optimizer + scheduler state reset (--reset_optim)")
        if override_lr:
            set_lr(state.opt_state, override_lr)
            log(f"override LR -> {override_lr} (--override_lr)")
    else:
        state = trainer.init_state(gen)
        log(f"initialised from train.seed {seed} | device {device}")
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    log(f"trainable params: {n_params / 1e6:.2f}M")

    if subsets is None:
        t0 = time.time()
        subsets = make_corpus(config.dataset.root, corpus_mols)
        log(f"corpus {config.dataset.root}: {corpus_mols} molecules generated in "
            f"{time.time() - t0:.1f} s ({len(subsets['train'])} train, "
            f"{len(subsets['val'])} val)")
    buckets = tuple(train_cfg.get("buckets", (24, 32, 48)))
    batch_size = int(train_cfg.batch_size)
    train_loader = iter(BucketedLoader(subsets["train"], featurizer, batch_size, buckets,
                                       shuffle=True, seed=seed, infinite=True))
    val_subset = subsets.get("val") or subsets["train"]
    max_iters = int(max_iters or train_cfg.max_iters)
    val_freq = int(train_cfg.val_freq)
    ckpt_freq = int(train_cfg.get("ckpt_freq", val_freq))
    val_batches = int(train_cfg.get("val_batches", 16))
    keep = int(train_cfg.get("keep_ckpts", 0) or 0)
    async_ckpt = AsyncCheckpointer() if train_cfg.get("ckpt_async", False) else None

    steps: List[dict] = []
    vals: List[dict] = []
    ckpts: List[str] = []
    first = state.step + 1
    t_log = time.time()
    for it in range(first, max_iters + 1):
        batch = batch_to_device(next(train_loader), device)
        noise = trainer.draw_step_noise(batch, gen)
        before = dict(kernels.launch_counts)
        t0 = time.perf_counter()
        if it == profile_at:
            path = os.path.join(log_dir, "profile", f"trace_it{it}.json")
            state, aux = _profiled(lambda: trainer.train_step(state, batch, noise), path)
            log(f"profiler trace of iteration {it} written to {path}")
        else:
            state, aux = trainer.train_step(state, batch, noise)
        aux = {k: float(v) for k, v in aux.items()}
        dt = time.perf_counter() - t0
        steps.append({"it": it, "n": int(batch["node_type"].shape[1]), "s": dt,
                      "launches": {k: kernels.launch_counts[k] - before[k] for k in before},
                      **aux, "lr": get_lr(state.opt_state)})
        if it % 100 == 0 or it == first:
            elapsed = time.time() - t_log
            sps = (100 if it > first else 1) / elapsed
            t_log = time.time()
            terms = " ".join(f"{k} {v:.4f}" for k, v in aux.items()
                             if k not in ("loss", "grad_norm"))
            log(f"[it {it}] loss {aux['loss']:.4f} ({terms}) "
                f"| grad {aux['grad_norm']:.2f} | lr {get_lr(state.opt_state):.2e} "
                f"| {sps:.2f} it/s")

        if it % val_freq == 0:
            val_loader = BucketedLoader(val_subset, featurizer, batch_size, buckets,
                                        shuffle=False, infinite=False, drop_last=False,
                                        prefetch=0)
            losses = []
            for vb, vbatch in enumerate(val_loader):
                if vb >= val_batches:
                    break
                vbatch = batch_to_device(vbatch, device)
                vnoise = trainer.draw_noise(vbatch, gen)
                losses.append(float(trainer.eval_step(state.params, vbatch, vnoise)["loss"]))
            val_loss = float(np.mean(losses)) if losses else float("nan")
            state = trainer.scheduler_step(state, val_loss)
            vals.append({"it": it, "loss": val_loss, "batches": len(losses),
                         "lr": get_lr(state.opt_state)})
            log(f"[val {it}] loss {val_loss:.4f}")

        if it % ckpt_freq == 0 or it == max_iters:
            path = os.path.join(ckpt_dir, f"{it}.ckpt")
            if async_ckpt is not None:
                async_ckpt.save(path, state, config, scheduler=trainer.scheduler)
            else:
                trainer.save_checkpoint(path, state, config)
            ckpts.append(path)
            log(f"saved {path}")
            prune_checkpoints(ckpt_dir, keep)
    if async_ckpt is not None:
        async_ckpt.wait()
        prune_checkpoints(ckpt_dir, keep)
    log("done")
    return {"log_dir": log_dir, "steps": steps, "val": vals, "checkpoints": ckpts,
            "state": state, "trainer": trainer}


def run(config: dict, resume: Optional[str] = None, device: "str | torch.device | None" = None,
        logdir: str = "./logs_torch", name: str = "train", max_iters: Optional[int] = None,
        reset_ema: bool = False, reset_optim: bool = False, override_lr: Optional[float] = None,
        profile_at: int = 0, corpus_mols: int = DEFAULT_CORPUS_MOLS,
        subsets: Optional[Dict[str, list]] = None, log: Callable[[str], None] = print) -> dict:
    """Train MolDiff with ``config``, from ``resume`` or from scratch ->
    :func:`fit`'s summary. ``subsets``: {"train", "val"} record lists to
    use instead of the generated corpus."""
    config = Config(config)
    device = resolve_device(device)
    featurizer = featurizer_from_config(config)
    model = MolDiff(config.model, featurizer.num_node_types, featurizer.num_edge_types,
                    device=device)
    return fit(config, model, featurizer, device, resume, logdir, name, max_iters, corpus_mols,
               subsets, log, reset_ema=reset_ema, reset_optim=reset_optim,
               override_lr=override_lr, profile_at=profile_at)


def main(argv=None) -> str:
    from ..utils.config import load_config

    ap = argparse.ArgumentParser(description="train MolDiff with moldiff_tpu_torch")
    ap.add_argument("--config", required=True)
    ap.add_argument("--resume", default=None,
                    help="checkpoint to continue from (default: fresh params from train.seed)")
    ap.add_argument("--logdir", default="./logs_torch")
    ap.add_argument("--name", default=None)
    ap.add_argument("--max_iters", type=int, default=None)
    ap.add_argument("--reset_ema", action="store_true")
    ap.add_argument("--reset_optim", action="store_true")
    ap.add_argument("--override_lr", type=float, default=None,
                    help="after --resume, replace the restored learning rate")
    ap.add_argument("--profile_at", type=int, default=0,
                    help="write a torch.profiler trace of this iteration under the log dir")
    ap.add_argument("--corpus_mols", type=int, default=DEFAULT_CORPUS_MOLS,
                    help="molecules of the config's corpus to generate in memory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    config = load_config(args.config)
    name = args.name or os.path.splitext(os.path.basename(args.config))[0]
    out = run(config, args.resume, device=args.device, logdir=args.logdir, name=name,
              max_iters=args.max_iters, reset_ema=args.reset_ema, reset_optim=args.reset_optim,
              override_lr=args.override_lr, profile_at=args.profile_at,
              corpus_mols=args.corpus_mols)
    return out["log_dir"]
