"""Unguided sampling from a committed checkpoint (scripts/sample_drug3d.py).

  python -m moldiff_tpu_torch.sample --config configs/sample/sample_flagship_v2.yml \
      [--device cuda|cpu] [--outdir outputs_torch] [--num_mols N] [--batch_size B]

The model config comes from the checkpoint. Writes SMILES.txt, one SDF per
finished molecule under SDF/, and summary.json (success rate with its
Wilson interval, throughput, accept stages, failure reasons) into
``<outdir>/<config name>_<time>/``. :func:`run` is the same path for a
caller that already holds the ``sample`` settings as a dict.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch

from ..chem.sdf import write_sdf
from ..data.featurize import featurizer_from_config
from ..models.moldiff import MolDiff, resolve_device
from ..utils.checkpoint import load_checkpoint
from ..utils.config import Config
from .pipeline import MolSampler


def wilson_interval(k: int, n: int, z: float = 1.959964) -> tuple:
    """95 % Wilson score interval of a proportion k / n."""
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    den = 1.0 + z * z / n
    mid = (p + z * z / (2 * n)) / den
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    # the exact ends at k = 0 and k = n, which rounding would miss
    return (0.0 if k == 0 else mid - half, 1.0 if k == n else mid + half)


def build_sampler(checkpoint: str, sample_cfg: dict, device: torch.device,
                  batch_size: Optional[int] = None):
    """(sampler, params) for a checkpoint and the ``sample`` settings."""
    ckpt = load_checkpoint(checkpoint, device)
    train_config = Config(ckpt["config"])
    featurizer = featurizer_from_config(train_config)
    model = MolDiff(train_config.model, featurizer.num_node_types, featurizer.num_edge_types,
                    device=device)
    kw = {}
    if sample_cfg.get("size_mean"):
        kw["size_mean"] = float(sample_cfg["size_mean"])
    if sample_cfg.get("size_std"):
        kw["size_std"] = float(sample_cfg["size_std"])
    if sample_cfg.get("buckets"):
        kw["buckets"] = tuple(int(b) for b in sample_cfg["buckets"])
    sampler = MolSampler(
        model, featurizer, batch_size=min(batch_size or sample_cfg["batch_size"], 256),
        sanitize_mode=str(sample_cfg.get("sanitize_mode") or "reference"),
        commit=str(sample_cfg.get("commit") or "none"), **kw)
    return sampler, ckpt["params"]


def run(config: dict, device=None, outdir: str = "outputs_torch",
        num_mols: Optional[int] = None, batch_size: Optional[int] = None,
        run_name: str = "sample", log=print) -> dict:
    """Sample per ``config`` ({'model': {'checkpoint'}, 'sample': {...}}),
    write the outputs and return the summary."""
    device = resolve_device(device)
    scfg = dict(config["sample"])
    for key in ("guidance", "bond_predictor", "num_steps", "add_edge", "edge_guidance",
                "save_traj_prob"):
        if scfg.get(key) or config.get(key):
            raise NotImplementedError(f"sample.{key} is not ported yet")
    if str(scfg.get("pos_sampler") or "ddpm") != "ddpm":
        raise NotImplementedError("only the ddpm position sampler is ported")
    torch.manual_seed(int(scfg["seed"]))
    sampler, params = build_sampler(config["model"]["checkpoint"], scfg, device, batch_size)
    num_mols = num_mols or int(scfg["num_mols"])
    generator = torch.Generator(device=device)
    generator.manual_seed(int(scfg["seed"]))
    rng = np.random.default_rng(int(scfg["seed"]))

    t0 = time.time()
    pool = sampler.generate(params, num_mols, generator, rng=rng,
                            batch_graphs=batch_size or int(scfg["batch_size"]), logger=log)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    n_fin, n_fail = len(pool["finished"]), len(pool["failed"])
    # the rate over every molecule classified: cutting 'finished' to
    # num_mols first (as the JAX CLI's success does) biases it low by up to
    # one batch of finished molecules
    k, n_all = pool["classified"]["finished"], pool["classified"]["finished"] + n_fail
    lo, hi = wilson_interval(k, n_all)
    summary = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "num_finished": n_fin,
        "num_failed": n_fail,
        "num_classified": n_all,
        "success_rate": k / max(n_all, 1),
        "success_wilson95": [lo, hi],
        "success_rate_after_cut": n_fin / max(n_fin + n_fail, 1),
        "wall_s": wall,
        "mols_per_s": n_fin / max(wall, 1e-9),
        "chains": sampler.chains,
        "chain_s": sampler.chain_s,
        "batch_size": sampler.batch_size,
        "commit": sampler.commit,
        "sanitize_mode": sampler.sanitize_mode,
        "accept_stage_counts": dict(Counter(e.get("stage") or "unknown"
                                            for e in pool["finished"])),
        "failure_reason_counts": dict(Counter(e["reason"] for e in pool["failed"])),
    }
    out_dir = os.path.join(outdir, run_name)
    sdf_dir = os.path.join(out_dir, "SDF")
    os.makedirs(sdf_dir, exist_ok=True)
    with open(os.path.join(out_dir, "SMILES.txt"), "w") as f:
        for e in pool["finished"]:
            f.write(e["smiles"] + "\n")
    for k, e in enumerate(pool["finished"]):
        write_sdf([e["mol"]], os.path.join(sdf_dir, f"{k}.sdf"))
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log(f"generated {n_fin} molecules in {wall:.1f} s | success {summary['success_rate']:.4f} "
        f"[{lo:.4f}, {hi:.4f}] -> {out_dir}")
    return summary


def main(argv=None) -> dict:
    from ..utils.config import load_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True, help="sample config (YAML)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--outdir", default="outputs_torch")
    ap.add_argument("--num_mols", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    args = ap.parse_args(argv)
    config = load_config(args.config)
    tag = os.path.splitext(os.path.basename(args.config))[0]
    return run(config, device=args.device, outdir=args.outdir, num_mols=args.num_mols,
               batch_size=args.batch_size, run_name=f"{tag}_{time.strftime('%Y%m%d_%H%M%S')}")
