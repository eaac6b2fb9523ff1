"""Sampling failure-mode autopsy.

Breaks a sampling pool's failures down by cause and, for disconnects,
measures the SPATIAL gap between fragments — distinguishing geometry
failures (fragments far apart; position-space bond guidance can help) from
bond-type failures (fragments at bonding distance but unbonded; a
categorical-head problem that position guidance cannot fix). Round-2
finding on the synthetic corpus: 100% of failures are disconnects with a
median inter-fragment gap of ~1.9 A — i.e. bond-type failures
(BASELINE.md failure-mode table).
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional

import numpy as np


def fragment_split(n_atoms: int, bond_index) -> List[List[int]]:
    """Connected components from a bond index [2, E] (largest first)."""
    parent = list(range(n_atoms))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    if bond_index is not None and np.size(bond_index):
        for i, j in zip(*np.asarray(bond_index)):
            ri, rj = find(int(i)), find(int(j))
            if ri != rj:
                parent[ri] = rj
    comps = collections.defaultdict(list)
    for i in range(n_atoms):
        comps[find(i)].append(i)
    return sorted(comps.values(), key=len, reverse=True)


def disconnect_autopsy(decoded: dict) -> Optional[dict]:
    """For a disconnected decode: fragment count/sizes and the minimum
    spatial distance between the main fragment and each secondary one."""
    n = len(decoded["element"])
    comps = fragment_split(n, decoded.get("bond_index"))
    if len(comps) < 2:
        return None
    pos = np.asarray(decoded["atom_pos"])
    main = comps[0]
    gaps = []
    for frag in comps[1:]:
        gaps.append(float(min(
            np.linalg.norm(pos[i] - pos[j]) for i in main for j in frag
        )))
    return {
        "n_fragments": len(comps),
        "fragment_sizes": [len(c) for c in comps],
        "min_gaps": gaps,
    }


def analyze_pool(pool: Dict[str, list], bond_gap: float = 2.0) -> dict:
    """Failure histogram + disconnect autopsy for a sampling pool
    (the `samples_all.pkl` dict: {'finished': [...], 'failed': [...]}).

    ``bond_gap``: a disconnect whose closest inter-fragment pair is within
    this distance counts as a BOND-TYPE failure (atoms touching, no bond);
    farther apart counts as a GEOMETRY failure.
    """
    reasons = collections.Counter(e["reason"] for e in pool.get("failed", []))
    gaps: List[float] = []
    n_bondtype = n_geometry = 0
    sizes_failed = []
    for e in pool.get("failed", []):
        if e.get("reason") != "disconnect":
            continue
        a = disconnect_autopsy(e["decoded"])
        if a is None:
            continue
        sizes_failed.append(len(e["decoded"]["element"]))
        g = min(a["min_gaps"])
        gaps.append(g)
        if g <= bond_gap:
            n_bondtype += 1
        else:
            n_geometry += 1
    n_fin = len(pool.get("finished", []))
    n_fail = len(pool.get("failed", []))
    out = {
        "finished": n_fin,
        "failed": n_fail,
        "success": n_fin / max(n_fin + n_fail, 1),
        "failure_modes": dict(reasons),
        "disconnect_bondtype": n_bondtype,   # gap <= bond_gap
        "disconnect_geometry": n_geometry,   # gap >  bond_gap
    }
    if gaps:
        out["gap_mean"] = float(np.mean(gaps))
        out["gap_median"] = float(np.median(gaps))
        out["failed_size_mean"] = float(np.mean(sizes_failed))
    return out
