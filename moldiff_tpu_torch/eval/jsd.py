"""Jensen-Shannon divergence harness for distribution comparisons.

First-party analogue of the reference's notebook JSD analysis
(`reference/scripts/analyze_generated.ipynb` cells 12-13, 31-81):
fixed-bin histograms (bond length 0.02 A, angles/dihedrals 5 deg, counts
discrete) compared with scipy's jensenshannon.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.spatial.distance import jensenshannon

BIN_WIDTHS = {"length": 0.02, "angle": 5.0, "dihedral": 5.0}


def hist_jsd(
    a: np.ndarray, b: np.ndarray, bin_width: Optional[float] = None,
    discrete: bool = False,
) -> float:
    """JSD between two samples via shared fixed-width (or discrete) bins."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    if a.size == 0 or b.size == 0:
        return float("nan")
    if discrete:
        lo = int(min(a.min(), b.min()))
        hi = int(max(a.max(), b.max()))
        bins = np.arange(lo, hi + 2) - 0.5
    else:
        assert bin_width is not None
        lo = min(a.min(), b.min())
        hi = max(a.max(), b.max())
        bins = np.arange(lo, hi + bin_width, bin_width)
        if len(bins) < 2:
            bins = np.array([lo, lo + bin_width])
    pa, _ = np.histogram(a, bins=bins)
    pb, _ = np.histogram(b, bins=bins)
    return float(jensenshannon(pa, pb, base=2))


def counter_jsd(ca: Dict, cb: Dict) -> float:
    """JSD between two count dicts over the union of keys (bond-type /
    ring-type distributions)."""
    keys = sorted(set(ca) | set(cb))
    if not keys:
        return float("nan")
    pa = np.array([ca.get(k, 0) for k in keys], dtype=float)
    pb = np.array([cb.get(k, 0) for k in keys], dtype=float)
    if pa.sum() == 0 or pb.sum() == 0:
        return float("nan")
    return float(jensenshannon(pa, pb, base=2))


def local3d_jsd(
    gen: Dict[str, np.ndarray], ref: Dict[str, np.ndarray], type_: str
) -> Dict[str, float]:
    """Per-pattern JSDs for Local3D outputs + their mean."""
    bw = BIN_WIDTHS[type_]
    out = {}
    for pat in ref:
        out[pat] = hist_jsd(gen.get(pat, np.array([])), ref[pat], bin_width=bw)
    vals = [v for v in out.values() if np.isfinite(v)]
    out["_mean"] = float(np.mean(vals)) if vals else float("nan")
    return out
