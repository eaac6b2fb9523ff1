"""Sampling sharded over processes (moldiff_tpu/parallel/multihost.py).

Generation is independent per molecule, so the pool is split over
processes: each takes a disjoint slice (:func:`shard_range`), draws its
own reproducible streams (:func:`shard_seeds`), writes its results into
``<outdir>/shard_<pid>`` (:func:`shard_dir`), and the processes exchange
only their pool counts (:func:`allgather_counts`). :func:`merge_shards`
(the sample CLI's ``--merge``) combines the shard directories into the
one-process layout, writing the files JAX's ``merge_shards`` writes.

One departure: JAX folds the process id into its PRNG key
(``jax.random.fold_in``), which cannot be reproduced without JAX; here the
torch generator's seed is derived from the pair (seed, process id), the
pair JAX's CLI seeds numpy's generator with (scripts/sample_drug3d.py:298).
"""
from __future__ import annotations

import json
import os
import pickle
import shutil

import numpy as np
import torch
import torch.distributed as dist


def shard_range(num_mols: int, process_id: int, num_processes: int):
    """Disjoint [start, stop) slice of the pool for this process; the first
    ``num_mols % num_processes`` shards take one extra molecule."""
    base, extra = divmod(num_mols, num_processes)
    start = process_id * base + min(process_id, extra)
    stop = start + base + (1 if process_id < extra else 0)
    return start, stop


def shard_seeds(seed: int, process_id: int) -> tuple:
    """(the torch generator's seed, numpy's seed) of process
    ``process_id``'s streams: distinct by process, the same on every run.
    numpy's is the pair (seed, process_id), as JAX's CLI; torch's is drawn
    from that pair's SeedSequence."""
    torch_seed = int(np.random.SeedSequence((int(seed), int(process_id))).generate_state(
        1, np.uint64)[0] >> np.uint64(1))
    return torch_seed, (int(seed), int(process_id))


def allgather_counts(finished: int, failed: int) -> np.ndarray:
    """Every process's (finished, failed) pool counts -> [num_processes, 2]
    int array, the same on every process. The counts are host integers: on
    a gloo group they go as a host tensor, on an NCCL group as a tensor on
    this process's card (NCCL takes no other)."""
    device = torch.device("cpu")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    local = torch.tensor([finished, failed], dtype=torch.int64, device=device)
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    return torch.stack(parts).cpu().numpy()


def shard_dir(outdir: str, process_id: int) -> str:
    return os.path.join(outdir, f"shard_{process_id}")


def _sdf_sort_key(name: str):
    """Numeric order for <idx>.sdf files; non-numeric names sort after, by
    string, so traj/aux files can't scramble the molecule numbering."""
    stem = os.path.splitext(name)[0]
    try:
        return (0, int(stem), "")
    except ValueError:
        return (1, 0, stem)


def merge_shards(outdir: str, remove: bool = False) -> dict:
    """Merge ``shard_*`` subdirectories (the per-process sampling outputs)
    into the single-host output layout (multihost.py:58-140):

      SMILES.txt           concatenated (shard order, then line order)
      SDF/<idx>.sdf        renumbered globally
      samples_all.pkl      pools concatenated
      meta.json            per-shard provenance

    Shard dirs and sdf files are ordered numerically (shard_10 after
    shard_2; 10.sdf after 2.sdf) so the renumbered SDFs line up with the
    concatenated SMILES.txt line order. Returns the merged pool dict.
    """
    shards = sorted(
        (d for d in os.listdir(outdir)
         if d.startswith("shard_") and os.path.isdir(os.path.join(outdir, d))),
        key=lambda d: int(d.split("_")[1]),
    )
    if not shards:
        raise FileNotFoundError(f"no shard_* dirs under {outdir}")

    merged = {"finished": [], "failed": []}
    smiles_lines = []
    sdf_out = os.path.join(outdir, "SDF")
    os.makedirs(sdf_out, exist_ok=True)
    idx = 0
    meta = []
    for sh in shards:
        sdir = os.path.join(outdir, sh)
        with open(os.path.join(sdir, "samples_all.pkl"), "rb") as f:
            pool = pickle.load(f)
        merged["finished"].extend(pool.get("finished", []))
        merged["failed"].extend(pool.get("failed", []))
        sm_path = os.path.join(sdir, "SMILES.txt")
        if os.path.exists(sm_path):
            with open(sm_path) as f:
                smiles_lines.extend(f.read().splitlines())
        shard_sdf = os.path.join(sdir, "sdf")
        if not os.path.isdir(shard_sdf):
            shard_sdf = os.path.join(sdir, "SDF")  # sample CLI layout
        if os.path.isdir(shard_sdf):
            names = [n for n in os.listdir(shard_sdf) if n.endswith(".sdf")]
            for name in sorted(names, key=_sdf_sort_key):
                shutil.copyfile(os.path.join(shard_sdf, name),
                                os.path.join(sdf_out, f"{idx}.sdf"))
                idx += 1
        meta.append({
            "shard": sh,
            "finished": len(pool.get("finished", [])),
            "failed": len(pool.get("failed", [])),
        })

    with open(os.path.join(outdir, "SMILES.txt"), "w") as f:
        f.write("\n".join(smiles_lines) + ("\n" if smiles_lines else ""))
    with open(os.path.join(outdir, "samples_all.pkl"), "wb") as f:
        pickle.dump(merged, f)
    with open(os.path.join(outdir, "meta.json"), "w") as f:
        json.dump({"shards": meta}, f, indent=1)
    if remove:
        for sh in shards:
            shutil.rmtree(os.path.join(outdir, sh))
    return merged
