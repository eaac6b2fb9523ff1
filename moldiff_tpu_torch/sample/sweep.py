"""Guidance-scale sweep (scripts/guidance_sweep.py): one denoiser and one
bond-predictor checkpoint, several guidance scales; per setting the success
rate with its Wilson 95 % interval and the failure-mode histogram
(eval/failure_analysis.py analyze_pool), and with ``--dataset_root`` the
mean bond-length JSD against the dataset's test split.

  python -m moldiff_tpu_torch.sample.sweep --ckpt ckpts/flagship_v2.ckpt \
      --bp_ckpt ckpts/bondpred_v2.ckpt --scales 1e-5,3e-5,1e-4 [--mode uncertainty] \
      [--num_mols 1000] [--batch_size 128] [--seed 2023] [--size_mean 18] [--size_std 5] \
      [--skip_unguided] [--use_ema] [--num_steps S] [--add_edge distance] \
      [--dataset_root DIR] [--recon_workers K] [--device cuda|cpu] [--out sweep.json]

One guided sampler serves every scale (``MolSampler.set_guidance_scale``
between pools), each pool drawn from the same seed; the unguided pool
first unless ``--skip_unguided``. The JSON written to ``--out`` has the
JAX script's keys, and a markdown table is printed at the end. Heavy
imports (torch, the models) happen inside :func:`main`, so that the
spawned classification workers of ``--recon_workers`` import none of them.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def run_pool(sampler, params, num_mols: int, seed: int, device, log=None,
             geom_ref=None) -> dict:
    """One pool of ``num_mols`` finished molecules from ``seed`` ->
    analyze_pool's dict, ``ci95`` and, with ``geom_ref``, ``geometry_jsd``
    (guidance_sweep.py:38-55)."""
    import torch

    from ..eval.failure_analysis import analyze_pool
    from .cli import wilson_interval

    pool = sampler.generate(params, num_mols, torch.Generator(device=device).manual_seed(seed),
                            rng=np.random.default_rng(seed), logger=log)
    out = analyze_pool(pool)
    lo, hi = wilson_interval(out["finished"], out["finished"] + out["failed"])
    out["ci95"] = [round(lo, 4), round(hi, 4)]
    if geom_ref is not None:
        out["geometry_jsd"] = geometry_jsd([e["mol"] for e in pool["finished"]], geom_ref)
    return out


def geometry_reference(dataset_root: str, limit: int = 500) -> tuple:
    """(Local3D with its predefined bond patterns, the bond lengths of the
    first ``limit`` sanitized molecules of the dataset's test split) (the
    reference notebook's protocol, guidance_sweep.py:58-87). A directory
    is read through its record store; a corpus recipe key is made in
    memory (eval/evaluate.py load_dataset_mols)."""
    from ..eval.evaluate import load_dataset_mols
    from ..eval.local3d import Local3D

    mols = load_dataset_mols(dataset_root, "test", limit=limit)
    l3d = Local3D()
    l3d.get_predefined()
    return l3d, l3d.calc_frequent(mols, "length")


def geometry_jsd(mols, geom_ref: tuple) -> dict:
    """Mean bond-length JSD against the test split over the predefined bond
    patterns with at least 10 lengths on both sides, 0.02 A bins
    (guidance_sweep.py:90-106)."""
    from ..eval.jsd import hist_jsd

    l3d, ref_lengths = geom_ref
    gen_lengths = l3d.calc_frequent(mols, "length")
    per_pattern = {}
    for pat, ref_vals in ref_lengths.items():
        gv = gen_lengths.get(pat)
        if gv is None or len(gv) < 10 or len(ref_vals) < 10:
            continue
        per_pattern[pat] = round(hist_jsd(gv, ref_vals, bin_width=0.02), 4)
    mean = (sum(per_pattern.values()) / len(per_pattern)) if per_pattern else None
    return {"mean_bond_length_jsd": round(mean, 4) if mean is not None else None,
            "n_patterns": len(per_pattern), "per_pattern": per_pattern}


def main(argv=None, log=print) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--bp_ckpt", required=True)
    ap.add_argument("--mode", default="uncertainty")
    ap.add_argument("--scales", default="1e-5,3e-5,1e-4")
    ap.add_argument("--num_mols", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=2023)
    ap.add_argument("--size_mean", type=float, default=18.0)
    ap.add_argument("--size_std", type=float, default=5.0)
    ap.add_argument("--skip_unguided", action="store_true")
    ap.add_argument("--use_ema", action="store_true", help="use the checkpoint's EMA weights")
    ap.add_argument("--num_steps", type=int, default=None,
                    help="respaced reverse chain on S evenly spaced steps")
    ap.add_argument("--add_edge", choices=["distance"], default=None,
                    help="perceive bonds from distances (the reference's 'edm' path)")
    ap.add_argument("--dataset_root", default=None,
                    help="also report the bond-length JSD against this dataset's test split")
    ap.add_argument("--recon_workers", type=int, default=0,
                    help="host classification worker processes (0 or 1: serial)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from ..data.featurize import featurizer_from_config
    from ..models.moldiff import MolDiff, resolve_device
    from ..utils.checkpoint import load_checkpoint
    from ..utils.config import Config
    from .cli import load_bond_predictor
    from .pipeline import MolSampler

    device = resolve_device(args.device)
    ckpt = load_checkpoint(args.ckpt, device)
    if args.use_ema:
        if ckpt.get("ema_params") is None:
            raise ValueError(f"--use_ema is set but {args.ckpt} has no ema_params")
        ckpt["params"] = ckpt["ema_params"]
    train_config = Config(ckpt["config"])
    featurizer = featurizer_from_config(train_config)
    model = MolDiff(train_config.model, featurizer.num_node_types, featurizer.num_edge_types,
                    device=device)
    params = ckpt["params"]
    bond_predictor = load_bond_predictor(args.bp_ckpt, featurizer, device)
    common = dict(batch_size=args.batch_size, size_mean=args.size_mean,
                  size_std=args.size_std, add_edge=args.add_edge, num_steps=args.num_steps,
                  recon_workers=args.recon_workers)
    results = {"ckpt": args.ckpt, "bp_ckpt": args.bp_ckpt, "ckpt_step": ckpt["step"],
               "mode": args.mode, "num_mols": args.num_mols, "seed": args.seed,
               "num_steps": args.num_steps, "runs": {}}
    geom_ref = None
    if args.dataset_root:
        geom_ref = geometry_reference(args.dataset_root)
        log("geometry reference ready (test-split bond lengths)")

    def pool(sampler, name: str) -> None:
        t0 = time.time()
        r = run_pool(sampler, params, args.num_mols, args.seed, device, log, geom_ref)
        r["wall_s"] = round(time.time() - t0, 1)
        results["runs"][name] = r
        log(f"{name}: {r}")

    if not args.skip_unguided:
        pool(MolSampler(model, featurizer, **common), "unguided")
    scales = [float(s) for s in args.scales.split(",") if s]
    sampler = MolSampler(model, featurizer, bond_predictor=bond_predictor,
                         guidance=(args.mode, scales[0]), **common)
    for s in scales:
        sampler.set_guidance_scale(s)
        pool(sampler, f"{args.mode}@{s:g}")

    out = args.out or f"sweep_{os.path.basename(args.ckpt)}.json"
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    log(f"wrote {out}")
    print("\n| setting | success | 95% CI | failures |")
    print("|---|---|---|---|")
    for name, r in results["runs"].items():
        print(f"| {name} | {r['success']:.3f} | [{r['ci95'][0]:.3f}, "
              f"{r['ci95'][1]:.3f}] | {r['failure_modes']} |")
    return results


if __name__ == "__main__":
    main()
