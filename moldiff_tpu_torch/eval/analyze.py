"""Aggregate per-method metrics into a JSD-vs-test comparison table
(scripts/analyze_generated.py, without pandas).

Loads the metric outputs of ``python -m moldiff_tpu_torch.eval`` (or of the
JAX package's scripts/evaluate_all.py: the same files) for a reference split
('test') and one or more generated-method dirs, computes JSDs (bond lengths
@0.02 A, angles/dihedrals @5 deg, count distributions, bond types, ring
sizes, top-10 ring intersection) and writes ``metrics_all_methods.csv`` in
the layout of the JAX script's ``pd.DataFrame(rows).T.to_csv``.

  python -m moldiff_tpu_torch.eval.analyze --ref <metrics_dir_of_test_split> \
      --methods name1=<metrics_dir> [name2=<dir> ...] --out metrics_all.csv
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import pickle
from typing import Dict

import numpy as np

from .evaluate import _cell, _kind
from .jsd import counter_jsd, hist_jsd, local3d_jsd


def read_metrics_csv(path: str) -> Dict[str, np.ndarray]:
    """mols.csv -> column name -> values, each column int64 where every
    field is an integer and float64 otherwise (pandas.read_csv's reading
    of the files evaluate.py writes)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        fields = [row for row in reader]
    out = {}
    for j, name in enumerate(header):
        col = [row[j] for row in fields]
        try:
            out[name] = np.array([int(v) for v in col], dtype=np.int64)
        except ValueError:
            out[name] = np.array([float(v) for v in col], dtype=np.float64)
    return out


def load_metrics_dir(d: str) -> dict:
    out = {}
    path = os.path.join(d, "mols.csv")
    if os.path.exists(path):
        out["df"] = read_metrics_csv(path)
    l3d = os.path.join(d, "local3d.pkl")
    if os.path.exists(l3d):
        with open(l3d, "rb") as f:
            out["local3d"] = pickle.load(f)
    rings = os.path.join(d, "freq_ring_type.pkl")
    if os.path.exists(rings):
        with open(rings, "rb") as f:
            out["rings"] = pickle.load(f)
    val = os.path.join(d, "validity.json")
    if os.path.exists(val):
        with open(val) as f:
            out["validity"] = json.load(f)
    return out


def _col_counts(df: Dict[str, np.ndarray], prefix: str) -> dict:
    cols = [c for c in df if c.startswith(prefix)]
    return {c[len(prefix):]: float(df[c].sum()) for c in cols}


def compare(ref: dict, gen: dict) -> dict:
    row = {}
    rdf, gdf = ref.get("df"), gen.get("df")
    if rdf is not None and gdf is not None:
        # discrete count-property JSDs (notebook cells 43-61)
        for col in ("n_atoms", "n_bonds", "n_rings", "n_rotatable",
                    "n_hacc", "n_hdon"):
            if col in rdf and col in gdf:
                row[f"jsd_{col}"] = hist_jsd(gdf[col], rdf[col], discrete=True)
        # element / bond-type distribution JSDs (cell 31)
        row["jsd_elem"] = counter_jsd(
            _col_counts(gdf, "elem_"), _col_counts(rdf, "elem_")
        )
        row["jsd_bond_type"] = counter_jsd(
            _col_counts(gdf, "bond_"), _col_counts(rdf, "bond_")
        )
        # ring-size distribution JSD (cell 73)
        row["jsd_ring_size"] = counter_jsd(
            _col_counts(gdf, "ring_size_"), _col_counts(rdf, "ring_size_")
        )
        # drug-chem means (NaN for a file without rows, as pandas reads it)
        for col in ("qed", "sa", "logp", "lipinski"):
            if col in gdf:
                row[f"mean_{col}"] = float(np.mean(gdf[col])) if len(gdf[col]) else float("nan")
    # local 3D JSDs (cells 12-13)
    if "local3d" in ref and "local3d" in gen:
        for type_ in ("length", "angle", "dihedral"):
            jsds = local3d_jsd(gen["local3d"][type_], ref["local3d"][type_], type_)
            row[f"jsd_{type_}_mean"] = jsds["_mean"]
    # top-10 ring intersection (cell 81)
    if "rings" in ref and "rings" in gen:
        r = set(ref["rings"]["rings"][:10])
        g = set(gen["rings"]["rings"][:10])
        row["ring_top10_intersection"] = len(r & g)
    if "validity" in gen:
        row.update({f"v_{k}": v for k, v in gen["validity"].items()
                    if isinstance(v, (int, float))})
    return row


def write_table_csv(rows: Dict[str, dict], path: str) -> None:
    """``pd.DataFrame(rows).T.to_csv(path)``: one line per method, the
    metrics in the order they first appear; every field float (an integer
    as 3.0) unless every method has every metric and all are integers; a
    missing value empty."""
    columns: Dict[str, None] = {}
    for r in rows.values():
        for k in r:
            columns.setdefault(k)
    cols = list(columns)
    kind = _kind([r.get(c) for r in rows.values() for c in cols])
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + cols)
        for name, r in rows.items():
            w.writerow([name] + [_cell(r.get(c), kind, False) for c in cols])


def main(argv=None) -> dict:
    """Write the table; returns {method: its metrics}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", required=True, help="metrics dir of the test split")
    ap.add_argument("--methods", nargs="+", required=True,
                    help="name=metrics_dir pairs")
    ap.add_argument("--out", default="metrics_all_methods.csv")
    args = ap.parse_args(argv)

    ref = load_metrics_dir(args.ref)
    rows = {}
    for spec in args.methods:
        name, d = spec.split("=", 1)
        rows[name] = compare(ref, load_metrics_dir(d))
    write_table_csv(rows, args.out)
    with open(args.out) as f:
        print(f.read(), end="")
    return rows


if __name__ == "__main__":
    main()
