"""Sampling from a committed checkpoint, guided by a bond predictor when the
config names one (scripts/sample_drug3d.py).

  python -m moldiff_tpu_torch.sample --config configs/sample/sample_flagship_v2.yml \
      [--device cuda|cpu] [--outdir outputs_torch] [--num_mols N] [--batch_size B] \
      [--use_ema] [--num_steps S] [--commit none|nodes|edges|both] [--add_edge MODE] \
      [--sanitize_mode reference|repo] [--edge_guidance W] [--edge_guidance_tmax T] \
      [--recon_workers K] [--run_name NAME]
  python -m moldiff_tpu_torch.sample --config configs/sample/sample_flagship_v2_guided.yml

The model configs come from the checkpoints. The config's top-level
``bond_predictor`` names the predictor's checkpoint; ``sample.guidance``
([mode, scale]), ``guidance_interval``, ``edge_guidance[_tmax]``,
``add_edge``, ``num_steps`` (a respaced chain), ``num_steps_gamma``,
``pos_sampler`` (ddpm or ddim), ``eta``, ``use_ema``, ``save_traj_prob`` and
``recon_workers`` (host classification over that many spawned processes;
each process of a multi-process run has its own) follow the JAX CLI
(scripts/sample_drug3d.py), whose single-process flags override them.
Writes SMILES.txt, one SDF per finished molecule under SDF/ (and
``traj_<k>.sdf``, one entry per state, for each molecule that kept its
trajectory), samples_all.pkl (every classified molecule, the JAX CLI's
layout) and summary.json (success rate with its Wilson interval,
throughput, the chain's settings, accept stages, failure reasons, aromatic
and triple-bond fractions) into ``<outdir>/<config name>_<time>/``.
:func:`run` is the same path for a caller that already holds the settings
as a dict.

Sampling over processes (scripts/sample_drug3d.py:104-142, 293-328): with
``--num_processes P --process_id p --coordinator HOST:PORT`` (or a
``file://`` rendezvous path) and a shared ``--run_name``, process p samples
its slice of the pool (parallel/multihost.py shard_range) into
``<run>/shard_<p>``, seeded by (seed, p), on ``cuda:<p mod cards>``, and
logs the pool counts gathered from every process (a gloo group: only host
integers cross); ``--merge RUN_DIR`` merges the shard directories and
exits. With more than one card visible and no ``--num_processes``,
:func:`run` starts one such process per card itself and merges at the end.
This is the port's form of JAX's in-process sampling mesh, which splits
each chain's batch over the devices: the pool is split instead, so the
molecules differ from a one-card run with the same seed. With one card
visible nothing changes.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch

from ..chem.mol import AROMATIC, Mol, MolError
from ..chem.sanitize import reconstruct_from_generated
from ..chem.sdf import write_sdf
from ..data.featurize import featurizer_from_config
from ..models.bond_predictor import BondPredictor
from ..models.moldiff import MolDiff, resolve_device
from ..parallel import launch, multihost
from ..parallel.mesh import initialize_distributed, rank_device, shutdown_distributed
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


def _fraction_with_bond(finished: list, order: int) -> float:
    """Share of finished molecules with at least one bond of ``order``."""
    n = sum(1 for e in finished if "mol" in e and any(b.order == order for b in e["mol"].bonds))
    return n / max(len(finished), 1)


def load_bond_predictor(checkpoint: str, featurizer, device: torch.device):
    """(BondPredictor, params) from a predictor checkpoint; no mask edge
    class at sample time (scripts/sample_drug3d.py:191-197)."""
    ckpt = load_checkpoint(checkpoint, device)
    bp = BondPredictor(Config(ckpt["config"]).model, featurizer.num_node_types,
                       featurizer.num_bond_types + 1, device=device)
    return bp, ckpt["params"]


def write_trajectory_sdf(featurizer, traj: dict, path: str) -> None:
    """One SDF entry per state of a molecule's trajectory, decoded and
    reconstructed, a one-oxygen placeholder where that fails
    (scripts/sample_drug3d.py:36-57)."""
    placeholder = Mol.from_arrays([8], pos=np.zeros((1, 3)))
    mols = []
    for t in range(traj["node"].shape[0]):
        decoded = featurizer.decode_output(traj["node"][t], traj["pos"][t], traj["halfedge"][t])
        try:
            mols.append(reconstruct_from_generated(
                decoded["element"], decoded["atom_pos"], decoded.get("bond_index"),
                decoded.get("bond_type")))
        except MolError:
            mols.append(placeholder)
    write_sdf(mols, path, names=[f"step_{t}" for t in range(len(mols))])


def build_sampler(checkpoint: str, sample_cfg: dict, device: torch.device,
                  batch_size: Optional[int] = None, bond_predictor: Optional[str] = None,
                  denoiser: Optional[dict] = None):
    """(sampler, params) for a checkpoint, the ``sample`` settings and,
    optionally, a bond-predictor checkpoint and settings to set on the
    checkpoint's ``model.denoiser`` (``{"fuse_block": True}``: the
    whole-block kernel), as scripts/sample_drug3d.py:161 sets ``remat``.
    ``sample.use_ema`` samples the checkpoint's EMA weights."""
    ckpt = load_checkpoint(checkpoint, device)
    if sample_cfg.get("use_ema"):
        if ckpt.get("ema_params") is None:
            raise ValueError(f"use_ema is set but {checkpoint} has no ema_params")
        ckpt["params"] = ckpt["ema_params"]
    train_config = Config(ckpt["config"])
    if denoiser:
        train_config = train_config.merged({"model": {"denoiser": denoiser}})
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
    bp = None
    if bond_predictor:
        bp = load_bond_predictor(bond_predictor, featurizer, device)
    guidance = sample_cfg.get("guidance")
    if guidance:
        guidance = (str(guidance[0]), float(guidance[1]))
    tmax = sample_cfg.get("edge_guidance_tmax")   # falsy: every step, as in JAX
    sampler = MolSampler(
        model, featurizer, batch_size=min(batch_size or sample_cfg["batch_size"], 256),
        sanitize_mode=str(sample_cfg.get("sanitize_mode") or "reference"),
        commit=str(sample_cfg.get("commit") or "none"), bond_predictor=bp,
        guidance=guidance or None,
        guidance_interval=int(sample_cfg.get("guidance_interval") or 1),
        edge_guidance=float(sample_cfg.get("edge_guidance") or 0.0),
        edge_guidance_tmax=tmax,
        add_edge=sample_cfg.get("add_edge") or None,
        num_steps=int(sample_cfg.get("num_steps") or 0) or None,
        pos_sampler=str(sample_cfg.get("pos_sampler") or "ddpm"),
        eta=float(sample_cfg.get("eta") or 0.0),
        respace_gamma=float(sample_cfg.get("num_steps_gamma") or 1.0),
        recon_workers=int(sample_cfg.get("recon_workers") or 0), **kw)
    return sampler, ckpt["params"]


def _sample_rank(rank: int, world: int, init_method: str, config: dict, device: str,
                 outdir: str, num_mols: Optional[int], batch_size: Optional[int],
                 run_name: str) -> dict:
    """One process of :func:`run`'s local pool sharding (launch.spawn)."""
    return run(config, device=device, outdir=outdir, num_mols=num_mols, batch_size=batch_size,
               run_name=run_name, log=lambda m: None, num_processes=world, process_id=rank,
               coordinator=init_method)


def run(config: dict, device=None, outdir: str = "outputs_torch",
        num_mols: Optional[int] = None, batch_size: Optional[int] = None,
        run_name: str = "sample", log=print, num_processes: Optional[int] = None,
        process_id: Optional[int] = None, coordinator: Optional[str] = None) -> dict:
    """Sample per ``config`` ({'model': {'checkpoint', optionally
    'denoiser': settings set on the checkpoint's model.denoiser}, 'sample':
    {...}}), write the outputs and return the summary. ``num_processes``
    P > 1: this is process ``process_id`` of P (``coordinator``: the
    rendezvous), sampling its shard of the pool into
    ``<outdir>/<run_name>/shard_<process_id>``; None, with more than one
    card visible: one process per card, merged at the end (the summary
    then holds the merged counts and each process's summary)."""
    device = resolve_device(device)
    if num_processes is None:
        cards = torch.cuda.device_count() if device.type == "cuda" else 1
        if cards > 1:
            return _run_local_shards(config, cards, outdir, num_mols, batch_size, run_name, log)
        num_processes = 1
    if num_processes > 1:
        device = rank_device(device, process_id)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        # only host integers (the pool counts) cross: a gloo group
        initialize_distributed(coordinator, num_processes, process_id, backend="gloo")
        # no teardown after an error: a peer may be gone, and the process's
        # exit ends the group
        out = _run(config, device, outdir, num_mols, batch_size, run_name, log, num_processes,
                   process_id)
        shutdown_distributed()
        return out
    return _run(config, device, outdir, num_mols, batch_size, run_name, log, 1, 0)


def _run_local_shards(config: dict, cards: int, outdir: str, num_mols: Optional[int],
                      batch_size: Optional[int], run_name: str, log) -> dict:
    shards = launch.spawn(_sample_rank, cards,
                          args=(config, "cuda", outdir, num_mols, batch_size, run_name))
    out_dir = os.path.join(outdir, run_name)
    merged = multihost.merge_shards(out_dir)
    n_fin, n_fail = len(merged["finished"]), len(merged["failed"])
    log(f"merged {cards} shards: {n_fin} finished, {n_fail} failed -> {out_dir}")
    return {"num_finished": n_fin, "num_failed": n_fail,
            "success_rate": n_fin / max(n_fin + n_fail, 1), "out_dir": out_dir,
            "shards": shards}


def _run(config: dict, device: torch.device, outdir: str, num_mols: Optional[int],
         batch_size: Optional[int], run_name: str, log, num_processes: int,
         process_id: int) -> dict:
    scfg = dict(config["sample"])
    torch.manual_seed(int(scfg["seed"]))
    sampler, params = build_sampler(config["model"]["checkpoint"], scfg, device, batch_size,
                                    bond_predictor=config.get("bond_predictor"),
                                    denoiser=config["model"].get("denoiser"))
    num_mols = num_mols or int(scfg["num_mols"])
    seed = int(scfg["seed"])
    torch_seed, np_seed = seed, seed
    out_dir = os.path.join(outdir, run_name)
    if num_processes > 1:
        # a disjoint slice of the pool, independent reproducible streams
        start, stop = multihost.shard_range(num_mols, process_id, num_processes)
        num_mols = stop - start
        torch_seed, np_seed = multihost.shard_seeds(seed, process_id)
        out_dir = multihost.shard_dir(out_dir, process_id)
        log(f"process {process_id}/{num_processes}: sampling shard [{start}, {stop}) -> "
            f"{num_mols} molecules")
    generator = torch.Generator(device=device)
    generator.manual_seed(torch_seed)
    rng = np.random.default_rng(np_seed)
    # each finished molecule keeps its trajectory with this probability
    traj_prob = float(scfg.get("save_traj_prob") or 0.0)

    t0 = time.time()
    pool = sampler.generate(params, num_mols, generator, rng=rng,
                            batch_graphs=batch_size or int(scfg["batch_size"]), logger=log,
                            traj_prob=traj_prob)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    n_fin, n_fail = len(pool["finished"]), len(pool["failed"])
    # the JAX CLI's success: finished cut to num_mols over finished + failed
    # (scripts/sample_drug3d.py:316), the definition of its published bars
    lo, hi = wilson_interval(n_fin, n_fin + n_fail)
    # the rate over every molecule classified: cutting 'finished' to
    # num_mols first biases the rate above low by up to one batch of
    # finished molecules, which matters at small num_mols
    k, n_all = pool["classified"]["finished"], pool["classified"]["finished"] + n_fail
    lo_c, hi_c = wilson_interval(k, n_all)
    summary = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "num_finished": n_fin,
        "num_failed": n_fail,
        "num_classified": n_all,
        "success_rate": n_fin / max(n_fin + n_fail, 1),
        "success_wilson95": [lo, hi],
        "success_rate_classified": k / max(n_all, 1),
        "success_wilson95_classified": [lo_c, hi_c],
        "wall_s": wall,
        "mols_per_s": n_fin / max(wall, 1e-9),
        "chains": sampler.chains,
        "chain_s": sampler.chain_s,
        "batch_size": sampler.batch_size,
        "num_steps": sampler.steps,
        "num_steps_gamma": sampler.respace_gamma,
        "pos_sampler": sampler.pos_sampler,
        "eta": sampler.eta,
        "use_ema": bool(scfg.get("use_ema")),
        "commit": sampler.commit,
        "sanitize_mode": sampler.sanitize_mode,
        "guidance": list(sampler.guidance) if sampler.guidance else None,
        "guidance_interval": sampler.guidance_interval,
        "edge_guidance": sampler.edge_guidance,
        "edge_guidance_tmax": sampler.edge_guidance_tmax,
        "add_edge": sampler.add_edge,
        "recon_workers": sampler.recon_workers,
        "accept_stage_counts": dict(Counter(e.get("stage") or "unknown"
                                            for e in pool["finished"])),
        "failure_reason_counts": dict(Counter(e["reason"] for e in pool["failed"])),
        # aromatic / triple-bond exposure of the pool (sample_drug3d.py:368-396)
        "aromatic_mol_fraction": _fraction_with_bond(pool["finished"], AROMATIC),
        "triple_bond_mol_fraction": _fraction_with_bond(pool["finished"], 3),
    }
    if num_processes > 1:
        counts = multihost.allgather_counts(n_fin, n_fail)
        tot_fin, tot_fail = (int(x) for x in counts.sum(axis=0))
        summary["global_counts"] = counts.tolist()
        log(f"global pool: finished {tot_fin} | failed {tot_fail} | success "
            f"{tot_fin / max(tot_fin + tot_fail, 1):.3f}")
    summary["out_dir"] = out_dir
    sdf_dir = os.path.join(out_dir, "SDF")
    os.makedirs(sdf_dir, exist_ok=True)
    with open(os.path.join(out_dir, "SMILES.txt"), "w") as f:
        for e in pool["finished"]:
            f.write(e["smiles"] + "\n")
    n_traj = 0
    for k, e in enumerate(pool["finished"]):
        write_sdf([e["mol"]], os.path.join(sdf_dir, f"{k}.sdf"))
        if "traj" in e:
            write_trajectory_sdf(sampler.featurizer, e["traj"],
                                 os.path.join(sdf_dir, f"traj_{k}.sdf"))
            n_traj += 1
    summary["num_trajectories"] = n_traj
    # every classified molecule, the JAX CLI's layout (sample_drug3d.py:347-362)
    with open(os.path.join(out_dir, "samples_all.pkl"), "wb") as f:
        pickle.dump({"finished": [{"smiles": e["smiles"], "decoded": e["decoded"],
                                   "stage": e.get("stage")} for e in pool["finished"]],
                     "failed": [{"reason": e["reason"], "decoded": e["decoded"]}
                                for e in pool["failed"]],
                     "wall_s": wall, "success_rate": summary["success_rate"]}, f)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log(f"generated {n_fin} molecules in {wall:.1f} s | success {summary['success_rate']:.4f} "
        f"[{lo:.4f}, {hi:.4f}] -> {out_dir}")
    return summary


def main(argv=None) -> dict:
    from ..utils.config import load_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None, help="sample config (YAML)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--outdir", default="outputs_torch")
    ap.add_argument("--num_mols", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    # the JAX CLI's single-process flags (scripts/sample_drug3d.py:63-107)
    ap.add_argument("--use_ema", action="store_true",
                    help="sample from the checkpoint's EMA weights")
    ap.add_argument("--num_steps", type=int, default=None,
                    help="respaced reverse chain of S steps (default: sample.num_steps or T)")
    ap.add_argument("--add_edge", choices=["distance", "connect"], default=None,
                    help="perceive bonds from the positions instead of reading the model's")
    ap.add_argument("--sanitize_mode", choices=["reference", "repo"], default=None)
    ap.add_argument("--commit", choices=["none", "nodes", "edges", "both"], default=None)
    ap.add_argument("--edge_guidance", type=float, default=None,
                    help="weight of the bond predictor's log-probs in the edge v0 prediction")
    ap.add_argument("--edge_guidance_tmax", type=int, default=None,
                    help="edge guidance only at original timesteps below this")
    ap.add_argument("--recon_workers", type=int, default=None,
                    help="host classification worker processes (0 or 1: serial; default: "
                         "sample.recon_workers or 0)")
    ap.add_argument("--run_name", default=None,
                    help="output directory name (default: config name + time; required to "
                         "line up the shard directories of a multi-process run)")
    # pool sharding over processes (parallel/multihost.py)
    ap.add_argument("--num_processes", type=int, default=None,
                    help="processes sharing the pool (default: 1, or one per visible card)")
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0, or a file:// rendezvous path")
    ap.add_argument("--merge", metavar="RUN_DIR", default=None,
                    help="merge the shard_* dirs of a multi-process run and exit (no sampling)")
    args = ap.parse_args(argv)
    if args.merge:
        merged = multihost.merge_shards(args.merge)
        print(f"merged {args.merge}: {len(merged['finished'])} finished, "
              f"{len(merged['failed'])} failed")
        return {"num_finished": len(merged["finished"]), "num_failed": len(merged["failed"]),
                "out_dir": args.merge}
    if not args.config:
        ap.error("--config is required unless --merge is given")
    config = load_config(args.config)
    sample = config["sample"]
    if args.use_ema:
        sample["use_ema"] = True
    for key in ("num_steps", "add_edge", "sanitize_mode", "commit", "edge_guidance",
                "edge_guidance_tmax", "recon_workers"):
        if getattr(args, key) is not None:
            sample[key] = getattr(args, key)
    tag = os.path.splitext(os.path.basename(args.config))[0]
    return run(config, device=args.device, outdir=args.outdir, num_mols=args.num_mols,
               batch_size=args.batch_size,
               run_name=args.run_name or f"{tag}_{time.strftime('%Y%m%d_%H%M%S')}",
               num_processes=args.num_processes, process_id=args.process_id,
               coordinator=args.coordinator)
