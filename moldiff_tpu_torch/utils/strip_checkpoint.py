"""Strip a training checkpoint down to a distribution checkpoint
(scripts/strip_checkpoint.py for the port).

  python -m moldiff_tpu_torch.utils.strip_checkpoint in.ckpt out.ckpt [--ema_only] [--f16]

A training checkpoint carries the optimizer's state (twice the params for
AdamW), the scheduler and the RNG key, so that a run can resume exactly;
sampling, serving and scoring read only {config, params, ema_params,
step}. This drops the resume-only fields, the port's optimizer state under
``extra["optimizer"]`` included; ``--ema_only`` keeps the EMA weights as
``params``; ``--f16`` stores float32 weights as float16 (the loaders
upcast them). Both packages load the result.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..train.trainer import write_checkpoint
from .checkpoint import load_checkpoint_numpy
from .tree import tree_map


def strip_checkpoint(ckpt: dict, ema_only: bool = False, f16: bool = False) -> dict:
    """The distribution subset of a training checkpoint dict."""
    params = ckpt["params"]
    ema = ckpt.get("ema_params")
    if ema_only:
        if ema is None:
            raise ValueError("ema_only: the checkpoint has no ema_params")
        params, ema = ema, None

    def cast(tree):
        if tree is None or not f16:
            return tree
        return tree_map(lambda x: x.astype(np.float16)
                        if isinstance(x, np.ndarray) and x.dtype == np.float32 else x, tree)

    config = ckpt["config"]
    extra = ckpt.get("extra")
    if extra is not None:
        extra = {k: v for k, v in extra.items() if k != "optimizer"}
    return {
        "config": config.to_dict() if hasattr(config, "to_dict") else config,
        "params": cast(params),
        "ema_params": cast(ema),
        "step": int(ckpt["step"]),
        "opt_state": None,
        "scheduler": None,
        "key": None,
        "extra": extra,
    }


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--ema_only", action="store_true",
                    help="keep only the EMA weights (as 'params')")
    ap.add_argument("--f16", action="store_true",
                    help="store float32 weights as float16 (the loaders upcast them)")
    args = ap.parse_args(argv)
    blob = strip_checkpoint(load_checkpoint_numpy(args.src), ema_only=args.ema_only,
                            f16=args.f16)
    write_checkpoint(args.dst, blob)
    print(f"{args.src} -> {args.dst}: {os.path.getsize(args.src) / 1e6:.1f} MB -> "
          f"{os.path.getsize(args.dst) / 1e6:.1f} MB (step {blob['step']})")
    return args.dst


if __name__ == "__main__":
    main()
