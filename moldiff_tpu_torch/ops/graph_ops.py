"""Complete-graph index tables and half-edge <-> dense conversions
(moldiff_tpu/ops/graph_ops.py).

Half-edges are the N(N-1)/2 unordered pairs (i, j), i < j, in row-major
upper-triangular order; the denoiser reads the dense directed layout
``[B, N, N, H]``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def triu_indices(n: int):
    """(iu, ju) int32 numpy arrays of the E = n(n-1)/2 half-edges, i < j."""
    iu, ju = np.triu_indices(n, k=1)
    return iu.astype(np.int32), ju.astype(np.int32)


def num_halfedges(n: int) -> int:
    return n * (n - 1) // 2


@functools.lru_cache(maxsize=None)
def halfedge_id_map(n: int) -> np.ndarray:
    """[N, N] int64 mapping (i, j) -> half-edge id; the diagonal maps to 0
    (always masked by the pair mask)."""
    iu, ju = triu_indices(n)
    m = np.zeros((n, n), dtype=np.int64)
    e = np.arange(len(iu), dtype=np.int64)
    m[iu, ju] = e
    m[ju, iu] = e
    return m


@functools.lru_cache(maxsize=None)
def _index_tensor(kind: str, n: int, device: str) -> torch.Tensor:
    if kind == "dense":
        arr = halfedge_id_map(n).reshape(-1)
    elif kind == "iu":
        arr = triu_indices(n)[0].astype(np.int64)
    else:
        arr = triu_indices(n)[1].astype(np.int64)
    return torch.from_numpy(arr).to(device)


def halfedge_to_dense(h_half: torch.Tensor, n: int) -> torch.Tensor:
    """[B, E, ...] -> [B, N, N, ...], each half-edge value at (i,j) and (j,i)."""
    idx = _index_tensor("dense", n, str(h_half.device))
    dense = h_half[:, idx]
    return dense.reshape(h_half.shape[:1] + (n, n) + h_half.shape[2:])


def dense_to_halfedge(h_dense: torch.Tensor) -> torch.Tensor:
    """[B, N, N, ...] -> [B, E, ...] reading the upper triangle."""
    n = h_dense.shape[1]
    dev = str(h_dense.device)
    return h_dense[:, _index_tensor("iu", n, dev), _index_tensor("ju", n, dev)]


def symmetrize_dense(h_dense: torch.Tensor) -> torch.Tensor:
    """h[i,j] + h[j,i]."""
    return h_dense + h_dense.transpose(1, 2)


def pair_mask_from_node_mask(node_mask: torch.Tensor) -> torch.Tensor:
    """[B, N] -> [B, N, N] float32: 1 where both endpoints are real, i != j."""
    m = node_mask.to(torch.float32)
    pm = m[:, :, None] * m[:, None, :]
    n = node_mask.shape[1]
    return pm * (1.0 - torch.eye(n, dtype=torch.float32, device=node_mask.device))

