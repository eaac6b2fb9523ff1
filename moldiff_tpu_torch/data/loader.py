"""Bucketed batch loader: records -> fixed-shape padded batches (a copy of
moldiff_tpu/data/loader.py).

Molecules are featurized on the host, grouped by size bucket and emitted
as (batch_size, bucket) padded numpy batches; a partial batch (drop_last
False) is padded to batch_size with fully masked rows. A background thread
keeps ``prefetch`` batches ready (0: none).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np

from .batching import pad_mols, pick_bucket
from .featurize import MolFeaturizer

BATCH_KEYS = ("node_type", "pos", "halfedge_type", "node_mask")


def featurize_record(rec: dict, featurizer: MolFeaturizer, rng: np.random.Generator,
                     center: bool = True) -> dict:
    """Record -> featurized dict; a random conformer when there are several
    (loader.py:20-32)."""
    pos = rec["pos"]
    if pos.ndim == 3:
        pos = pos[rng.integers(0, pos.shape[0])]
    bi = rec["bond_index"].astype(np.int64)
    bond_index = np.concatenate([bi, bi[::-1]], axis=1)
    bond_type = np.concatenate([rec["bond_type"], rec["bond_type"]]).astype(np.int64)
    return featurizer.featurize(rec["element"].astype(np.int64), pos, bond_index, bond_type,
                                center=center)


class BucketedLoader:
    """Infinite (or one-epoch) iterator of dict(node_type, pos,
    halfedge_type, node_mask) batches; molecules larger than the biggest
    bucket are skipped and counted (loader.py:35-138)."""

    def __init__(self, subset, featurizer: MolFeaturizer, batch_size: int,
                 buckets: Sequence[int] = (24, 32, 48), shuffle: bool = True, seed: int = 0,
                 infinite: bool = True, drop_last: bool = True, prefetch: int = 4):
        self.subset = subset
        self.featurizer = featurizer
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets))
        self.shuffle = shuffle
        self.infinite = infinite
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self.num_skipped = 0

    def _iter_batches(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        while True:
            pending: Dict[int, List[dict]] = {b: [] for b in self.buckets}
            idx = np.arange(len(self.subset))
            if self.shuffle:
                rng.shuffle(idx)
            for i in idx:
                feats = featurize_record(self.subset[int(i)], self.featurizer, rng)
                n = len(feats["node_type"])
                if n > self.buckets[-1]:
                    self.num_skipped += 1
                    continue
                b = pick_bucket(n, self.buckets)
                pending[b].append(feats)
                if len(pending[b]) == self.batch_size:
                    yield self._emit(pending[b], b)
                    pending[b] = []
            if not self.drop_last:
                for b, mols in pending.items():
                    if mols:
                        yield self._emit(mols, b)
            if not self.infinite:
                return

    def _emit(self, mols: List[dict], n_bucket: int) -> dict:
        padded = pad_mols(mols, n_max=n_bucket)
        out = {k: padded[k] for k in BATCH_KEYS}
        short = self.batch_size - len(mols)
        if short > 0:
            for k, v in out.items():
                out[k] = np.pad(v, [(0, short)] + [(0, 0)] * (v.ndim - 1))
        return out

    def __iter__(self) -> Iterator[dict]:
        if self.prefetch <= 0:
            yield from self._iter_batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()

        def worker():
            try:
                for b in self._iter_batches():
                    q.put(b)
            finally:
                q.put(done)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is done:
                return
            yield item
