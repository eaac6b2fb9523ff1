"""Training the bond predictor (scripts/train_bond.py).

  python -m moldiff_tpu_torch.train.bond --config configs/train/train_bondpred_v2.yml \
      [--resume ckpts/bondpred_40k.ckpt] [--max_iters N] [--corpus_mols M] \
      [--device cuda|cpu] [--logdir ./logs_torch] [--name NAME]

The loop is the denoiser's (cli.fit): from fresh params drawn from
``train.seed`` or from ``--resume``; a log line of ``loss`` and
``acc_bond``; validation whose mean loss steps the scheduler; checkpoints
with ``train.keep_ckpts`` and ``train.ckpt_async``; the data source and
the run's directory (log.txt, metrics.jsonl with the JAX CLI's
``train/loss`` and ``train/acc_bond`` at iteration 1 and every 100th and
``val/loss``, the event file) and the ``parallel:`` section (one worker
per rank, FSDP, sharded checkpoints) as cli.fit and cli.run_ranks say. The featurizer is the
config's (``transform.use_mask_edge: false``: bond types and "none", no
mask class), so the predictor has num_bond_types + 1 edge classes, as
sampling builds it. :func:`run` takes the config as a dict (the card
machine has no PyYAML).
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional

import torch

from ..data.featurize import featurizer_from_config
from ..models.bond_predictor import BondPredictor
from ..utils.config import Config
from .cli import DEFAULT_CORPUS_MOLS, fit, run_ranks


def bond_scalars(aux: dict, lr: float, steps_per_sec: float) -> dict:
    """The bond predictor's logged scalars (scripts/train_bond.py:131-132)."""
    return {"train/loss": aux["loss"], "train/acc_bond": aux["acc_bond"]}


def run(config: dict, resume: Optional[str] = None, device: "str | torch.device | None" = None,
        logdir: str = "./logs_torch", name: str = "train_bond", max_iters: Optional[int] = None,
        corpus_mols: int = DEFAULT_CORPUS_MOLS, subsets: Optional[Dict[str, list]] = None,
        log: Optional[Callable[[str], None]] = None, config_path: Optional[str] = None,
        backend: Optional[str] = None, check_replicas: bool = False) -> dict:
    """Train the bond predictor with ``config``, from ``resume`` or from
    scratch -> cli.fit's summary; the config's ``parallel:`` section as the
    denoiser's CLI reads it (cli.run_ranks)."""
    return run_ranks(_run_local, dict(config), device, backend, log, resume=resume,
                     logdir=logdir, name=name, max_iters=max_iters, corpus_mols=corpus_mols,
                     subsets=subsets, config_path=config_path, check_replicas=check_replicas)


def _run_local(config: dict, device: torch.device, mesh, log, **kwargs) -> dict:
    config = Config(config)
    featurizer = featurizer_from_config(config)
    model = BondPredictor(config.model, featurizer.num_node_types, featurizer.num_edge_types,
                          device=device)
    return fit(config, model, featurizer, device, kwargs.pop("resume"), kwargs.pop("logdir"),
               kwargs.pop("name"), kwargs.pop("max_iters"), kwargs.pop("corpus_mols"),
               kwargs.pop("subsets"), log, logger_name="train_bond", scalars=bond_scalars,
               mesh=mesh, **kwargs)


def main(argv=None) -> str:
    from ..utils.config import load_config

    ap = argparse.ArgumentParser(description="train the bond predictor with moldiff_tpu_torch")
    ap.add_argument("--config", required=True)
    ap.add_argument("--resume", default=None,
                    help="checkpoint to continue from (default: fresh params from train.seed)")
    ap.add_argument("--logdir", default="./logs_torch")
    ap.add_argument("--name", default=None)
    ap.add_argument("--max_iters", type=int, default=None)
    ap.add_argument("--corpus_mols", type=int, default=DEFAULT_CORPUS_MOLS,
                    help="when dataset.root is a corpus recipe and no directory: molecules "
                         "of it to generate in memory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    config = load_config(args.config)
    name = args.name or os.path.splitext(os.path.basename(args.config))[0]
    out = run(config, args.resume, device=args.device, logdir=args.logdir, name=name,
              max_iters=args.max_iters, corpus_mols=args.corpus_mols, config_path=args.config)
    return out["log_dir"]
