"""Padded dense batches (the parts of moldiff_tpu/data/batching.py that
sampling and training use, and moldiff_tpu/parallel/mesh.py's
``pad_batch_to_multiple``)."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.graph_ops import num_halfedges

DEFAULT_BUCKETS = (16, 24, 32, 40, 48, 64)


def node_mask_from_counts(n_nodes: np.ndarray, n_max: int) -> np.ndarray:
    """[B] counts -> [B, N] float32 mask."""
    return (np.arange(n_max)[None, :] < np.asarray(n_nodes)[:, None]).astype(np.float32)


def pick_bucket(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"molecule with {n} atoms exceeds largest bucket {buckets[-1]}")


def pad_mols(mols: List[dict], n_max: Optional[int] = None) -> dict:
    """Featurized molecules (MolFeaturizer.featurize dicts) -> one padded
    batch dict(node_type [B,N] int32, pos [B,N,3] float32, halfedge_type
    [B,E] int32, node_mask [B,N] float32, n_nodes [B] int32)
    (batching.py:61-92; each half-edge placed by its (i, j))."""
    sizes = np.array([len(m["node_type"]) for m in mols], dtype=np.int32)
    if n_max is None:
        n_max = pick_bucket(int(sizes.max()))
    assert sizes.max() <= n_max
    b = len(mols)
    node_type = np.zeros((b, n_max), dtype=np.int32)
    pos = np.zeros((b, n_max, 3), dtype=np.float32)
    halfedge_type = np.zeros((b, num_halfedges(n_max)), dtype=np.int32)
    for i, m in enumerate(mols):
        n = int(sizes[i])
        node_type[i, :n] = m["node_type"]
        pos[i, :n] = m["pos"]
        if num_halfedges(n):
            iu_s, ju_s = np.triu_indices(n, k=1)
            flat = iu_s * n_max - (iu_s * (iu_s + 1)) // 2 + (ju_s - iu_s - 1)
            halfedge_type[i, flat] = m["halfedge_type"]
    return {"node_type": node_type, "pos": pos, "halfedge_type": halfedge_type,
            "node_mask": node_mask_from_counts(sizes, n_max), "n_nodes": sizes}


def pad_batch_to_multiple(batch: dict, multiple: int) -> dict:
    """Pad the leading axis of every tensor to a multiple of ``multiple``
    with zeros: the padded graphs have node_mask 0 and add nothing to any
    masked reduction (mesh.py:337-349)."""
    rem = (-next(iter(batch.values())).shape[0]) % multiple
    if rem == 0:
        return batch
    return {k: torch.cat([v, v.new_zeros((rem,) + tuple(v.shape[1:]))]) for k, v in batch.items()}


def unpad_arrays(batch_arrays, n_nodes: np.ndarray):
    """Padded 'pred_node' [B,N,Kn], 'pred_pos' [B,N,3], 'pred_halfedge'
    [B,E,Ke] -> a list of per-molecule unpadded dicts."""
    pred_node = np.asarray(batch_arrays["pred_node"])
    pred_pos = np.asarray(batch_arrays["pred_pos"])
    pred_halfedge = np.asarray(batch_arrays["pred_halfedge"])
    n_max = pred_node.shape[1]
    out = []
    for i, n in enumerate(np.asarray(n_nodes)):
        n = int(n)
        iu_s, ju_s = np.triu_indices(n, k=1)
        flat = iu_s * n_max - (iu_s * (iu_s + 1)) // 2 + (ju_s - iu_s - 1)
        out.append(
            {
                "pred_node": pred_node[i, :n],
                "pred_pos": pred_pos[i, :n],
                "pred_halfedge": pred_halfedge[i, flat],
            }
        )
    return out


def split_trajectories(traj, n_nodes: np.ndarray) -> List[dict]:
    """Per-molecule unpadded trajectories (batching.py:121-142): traj is
    (node [S+1,B,N,Kn], pos [S+1,B,N,3], halfedge [S+1,B,E,Ke]) numpy
    arrays; returns one dict of 'node' / 'pos' / 'halfedge' per molecule."""
    node_t, pos_t, he_t = (np.asarray(t) for t in traj)
    n_max = node_t.shape[2]
    out = []
    for i, n in enumerate(np.asarray(n_nodes)):
        n = int(n)
        iu_s, ju_s = np.triu_indices(n, k=1)
        flat = iu_s * n_max - (iu_s * (iu_s + 1)) // 2 + (ju_s - iu_s - 1)
        out.append({"node": node_t[:, i, :n], "pos": pos_t[:, i, :n],
                    "halfedge": he_t[:, i, flat]})
    return out
