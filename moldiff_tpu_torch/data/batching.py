"""Padded dense batches (the parts of moldiff_tpu/data/batching.py that
sampling uses)."""
from __future__ import annotations

import numpy as np

DEFAULT_BUCKETS = (16, 24, 32, 40, 48, 64)


def node_mask_from_counts(n_nodes: np.ndarray, n_max: int) -> np.ndarray:
    """[B] counts -> [B, N] float32 mask."""
    return (np.arange(n_max)[None, :] < np.asarray(n_nodes)[:, None]).astype(np.float32)


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
