"""The port's evaluation CLIs (moldiff_tpu_torch.eval: evaluate.py and
analyze.py) against scripts/evaluate_all.py and scripts/analyze_generated.py
on copies of the same sample output directory: mols.csv byte-equal,
validity.json, local3d.pkl and freq_ring_type.pkl equal, the comparison
table's numbers to 1e-12 in the JAX script's layout; and the pandas layouts the
port writes with the csv module."""
import csv
import json
import math
import os
import pickle
import shutil
import sys
import types

import numpy as np
import pandas as pd
import pytest

from moldiff_tpu.chem import sdf as jsdf
from moldiff_tpu.sample.pipeline import classify_decoded
from moldiff_tpu_torch.eval import analyze as tanalyze
from moldiff_tpu_torch.eval import evaluate as tevaluate
from test_torch_eval import SMILES, _blocks, _random_pool, assert_same, decoded_of

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import analyze_generated as janalyze  # noqa: E402
import evaluate_all as jevaluate  # noqa: E402


def make_sample_dir(root: str, mode: str, extra: int = 6) -> dict:
    """A sample output directory in the JAX CLI's layout (SDF/<k>.sdf per
    finished molecule, samples_all.pkl, summary.json) from seeded molecules,
    random decoder outputs and disconnected pairs, classified by the JAX
    package under ``mode``."""
    decoded = _random_pool(12) + [decoded_of(("sdf", b)) for b in
                                  _blocks("v1", 41, extra) + _blocks("v2", 42, extra)]
    pool = {"finished": [], "failed": []}
    for d in decoded:
        e = classify_decoded(d, sanitize_mode=mode)
        pool[e["pool"]].append(e)
    os.makedirs(os.path.join(root, "SDF"))
    for k, e in enumerate(pool["finished"]):
        jsdf.write_sdf([e["mol"]], os.path.join(root, "SDF", f"{k}.sdf"))
    with open(os.path.join(root, "samples_all.pkl"), "wb") as f:
        pickle.dump({"finished": [{"smiles": e["smiles"], "decoded": e["decoded"],
                                   "stage": e.get("stage")} for e in pool["finished"]],
                     "failed": [{"reason": e["reason"], "decoded": e["decoded"]}
                                for e in pool["failed"]]}, f)
    with open(os.path.join(root, "summary.json"), "w") as f:
        json.dump({"sanitize_mode": mode, "num_finished": len(pool["finished"]),
                   "num_failed": len(pool["failed"])}, f)
    return {k: len(v) for k, v in pool.items()}


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("mode", ["reference", "repo"])
def test_generated_dir_matches_jax(tmp_path, mode):
    src = str(tmp_path / "src")
    counts = make_sample_dir(src, mode)
    assert counts["finished"] >= 20 and counts["failed"] >= 8, counts
    for side in ("jax", "torch"):
        shutil.copytree(src, str(tmp_path / side))
    jevaluate.main(["--root", str(tmp_path / "jax")])
    report = tevaluate.main(["--root", str(tmp_path / "torch")])
    dj, dt = str(tmp_path / "jax" / "metrics"), str(tmp_path / "torch" / "metrics")
    assert report["out_dir"] == dt and report["num_mols"] == counts["finished"]
    assert report["empty_rows"] == {f: [] for f in tevaluate.FAMILIES}
    assert _read(os.path.join(dt, "mols.csv")) == _read(os.path.join(dj, "mols.csv"))
    assert len(_read(os.path.join(dt, "mols.csv")).splitlines()) == counts["finished"] + 1
    with open(os.path.join(dj, "validity.json")) as f, open(os.path.join(dt, "validity.json")) as g:
        vj, vt = json.load(f), json.load(g)
    assert vj == vt and vt["n_complete"] == counts["finished"]
    assert vt["n_complete"] + vt["n_disconnect"] + vt["n_invalid"] == sum(counts.values())
    for name in ("local3d.pkl", "freq_ring_type.pkl"):
        assert_same(_load(os.path.join(dj, name)), _load(os.path.join(dt, name)))
    assert not os.path.exists(os.path.join(dt, "similarity.json"))


def test_smiles_file_matches_jax(tmp_path):
    path = tmp_path / "SMILES.txt"
    path.write_text("\n".join(SMILES[:12] + ["not_a_smiles", "C1CC"] + SMILES[12:]) + "\n")
    for side, main in (("jax", jevaluate.main), ("torch", tevaluate.main)):
        main(["--from_where", "smiles", "--root", str(path), "--outdir", str(tmp_path / side)])
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert _read(os.path.join(dt, "mols.csv")) == _read(os.path.join(dj, "mols.csv"))
    assert _load(os.path.join(dt, "local3d.pkl")) is None
    assert _load(os.path.join(dt, "freq_ring_type.pkl")) == \
        _load(os.path.join(dj, "freq_ring_type.pkl"))


def test_dataset_split_from_the_corpus_recipe(tmp_path):
    """--from_where dataset on a corpus recipe: the split's molecules are
    the JAX generator's (./data/synthetic: seed 7, v1, 80/10/10), with
    metrics, local3d and rings written and cached; a directory without a
    store or SDF files raises, naming the missing record store, and a root
    that is neither a directory nor a recipe raises; similarity.json for
    generated molecules against the recipe's train and val splits."""
    from moldiff_tpu.chem.smiles import mol_to_smiles as jsmiles
    from moldiff_tpu.data.synthetic import random_molecule
    from moldiff_tpu_torch.chem.smiles import mol_to_smiles as tsmiles

    rng = np.random.default_rng(7)
    want = [jsmiles(random_molecule(rng)) for _ in range(60)][54:]
    got = tevaluate.load_dataset_mols("./data/synthetic", "test", corpus_mols=60)
    assert [tsmiles(m) for m in got] == want
    assert len(tevaluate.load_dataset_mols("data/synthetic", "train", limit=5,
                                           corpus_mols=60)) == 5
    with pytest.raises(FileNotFoundError, match="record store"):
        tevaluate.load_dataset_mols(str(tmp_path), "test")
    with pytest.raises(ValueError, match="neither a directory nor a corpus recipe"):
        tevaluate.load_dataset_mols(str(tmp_path / "nowhere"), "test")

    out = str(tmp_path / "ref")
    argv = ["--from_where", "dataset", "--dataset_root", "./data/synthetic", "--split", "test",
            "--corpus_mols", "60", "--outdir", out]
    report = tevaluate.main(argv)
    assert report["num_mols"] == 6
    for name in ("mols.csv", "local3d.pkl", "freq_ring_type.pkl"):
        assert os.path.exists(os.path.join(out, name))
    assert tevaluate.main(argv)["num_mols"] == 0          # cached
    assert tevaluate.main(argv + ["--force"])["num_mols"] == 6

    src = str(tmp_path / "gen")
    make_sample_dir(src, "reference", extra=2)
    tevaluate.main(["--root", src, "--dataset_root", "./data/synthetic", "--corpus_mols", "60"])
    with open(os.path.join(src, "metrics", "similarity.json")) as f:
        sim = json.load(f)
    assert set(sim) == {"uniqueness", "novelty", "sim_with_train", "sim_with_val", "diversity"}
    assert all(math.isfinite(v) for v in sim.values())


def test_analyze_matches_jax(tmp_path):
    """compare() on two metric directories (a generated one and a dataset
    split's, each way round, and one against itself) and the table file."""
    src = str(tmp_path / "src")
    make_sample_dir(src, "reference")
    tevaluate.main(["--root", src])
    gen = os.path.join(src, "metrics")
    ref = str(tmp_path / "ref")
    tevaluate.main(["--from_where", "dataset", "--dataset_root", "./data/synthetic",
                    "--corpus_mols", "120", "--outdir", ref])
    for r, g in ((gen, gen), (gen, ref), (ref, gen)):
        want = janalyze.compare(janalyze.load_metrics_dir(r), janalyze.load_metrics_dir(g))
        got = tanalyze.compare(tanalyze.load_metrics_dir(r), tanalyze.load_metrics_dir(g))
        assert list(got) == list(want)
        for k in want:
            w, v = float(want[k]), float(got[k])
            assert (math.isnan(w) and math.isnan(v)) or abs(w - v) <= 1e-12, (k, w, v)
    argv = ["--ref", ref, "--methods", f"gen={gen}", f"test={ref}"]
    janalyze.main(argv + ["--out", str(tmp_path / "jax.csv")])
    rows = tanalyze.main(argv + ["--out", str(tmp_path / "torch.csv")])
    assert set(rows) == {"gen", "test"} and rows["test"]["jsd_elem"] == 0.0
    # the same layout; the numbers to 1e-12 (pandas.read_csv's float parser
    # can read a value one ulp off Python's float(), which moves a mean)
    with open(str(tmp_path / "jax.csv")) as f, open(str(tmp_path / "torch.csv")) as g:
        want, got = list(csv.reader(f)), list(csv.reader(g))
    assert [r[0] for r in got] == [r[0] for r in want] and got[0] == want[0]
    for rw, rg in zip(want[1:], got[1:]):
        assert len(rw) == len(rg) and [c == "" for c in rw] == [c == "" for c in rg]
        assert all(abs(float(a) - float(b)) <= 1e-12 for a, b in zip(rw[1:], rg[1:]) if a), (rw, rg)
        assert [c.endswith(".0") for c in rw] == [c.endswith(".0") for c in rg]


ROWS = {
    "ints": [{"a": 1, "b": 2}, {"a": 3, "b": 4}],
    "gaps": [{"a": 1, "b": 0.1}, {"a": 2, "c": 3}, {}],
    "nan_and_numpy": [{"x": float("nan"), "y": np.int64(3), "z": np.float64(1e-5)},
                      {"x": 2.5, "y": np.int64(-4), "z": 1e16}],
    "floats": [{"f": 0.1 + 0.2, "g": -0.0, "h": 123456789.123456789, "i": float("inf")}],
    "empty_rows": [{}, {}],
    "no_rows": [],
    "none": [{"v": None}, {"v": 7}],
}


@pytest.mark.parametrize("case", sorted(ROWS))
def test_rows_csv_is_pandas(tmp_path, case):
    """write_rows_csv == pd.DataFrame(rows).fillna(0).to_csv(index=False)."""
    rows = ROWS[case]
    path = str(tmp_path / "m.csv")
    tevaluate.write_rows_csv(rows, path)
    with open(path) as f:
        assert f.read() == pd.DataFrame(rows).fillna(0).to_csv(index=False)
    if rows and rows[0]:
        got = tanalyze.read_metrics_csv(path)
        df = pd.read_csv(path)
        assert list(got) == list(df.columns)
        for c in df.columns:
            # pandas' float parser may land one ulp off Python's float()
            assert got[c].dtype == df[c].values.dtype, c
            np.testing.assert_allclose(got[c], df[c].values, rtol=1e-15, atol=0)


def test_rows_csv_refuses_what_pandas_would_print_otherwise(tmp_path):
    """A bool or a string is no metric value: pandas would print it as
    True or as text, so the writer raises instead of printing 1."""
    for bad in ([{"ok": True}], [{"n": 1}, {"n": "x"}]):
        with pytest.raises(TypeError):
            tevaluate.write_rows_csv(bad, str(tmp_path / "m.csv"))


TABLES = {
    "mixed": {"m1": {"x": 0.5, "k": 3, "v_n": 10}, "m2": {"y": 0.25, "x": float("nan"), "k": 2}},
    "ints": {"m1": {"k": 3, "v_n": 10}, "m2": {"k": 1, "v_n": 2}},
    "one": {"only": {"jsd_elem": 0.125, "ring_top10_intersection": 4}},
    "empty": {"m1": {}, "m2": {}},
}


@pytest.mark.parametrize("case", sorted(TABLES))
def test_table_csv_is_pandas(tmp_path, case):
    """write_table_csv == pd.DataFrame(rows).T.to_csv()."""
    path = str(tmp_path / "t.csv")
    tanalyze.write_table_csv(TABLES[case], path)
    with open(path) as f:
        assert f.read() == pd.DataFrame(TABLES[case]).T.to_csv()


def test_missing_sa_table_stops_the_cli(tmp_path, monkeypatch):
    """Without the SA table the CLI raises before scoring: get_metric would
    otherwise turn every drug_chem row into zeros."""
    import importlib

    sa_score = importlib.import_module("moldiff_tpu_torch.eval.sa_score")

    monkeypatch.setattr(sa_score, "_DEFAULT_SCORER", None)
    monkeypatch.setattr(sa_score, "_SHIPPED_TABLE", str(tmp_path / "missing.pkl"))
    path = tmp_path / "SMILES.txt"
    path.write_text("CCO\n")
    with pytest.raises(FileNotFoundError):
        tevaluate.main(["--from_where", "smiles", "--root", str(path),
                        "--outdir", str(tmp_path / "m")])
    assert not os.path.exists(str(tmp_path / "m" / "mols.csv"))


def test_eval_modules_match_the_jax_package():
    """Each of the 13 JAX eval modules has its copy, and the package
    exports the same names."""
    import moldiff_tpu.eval as jeval
    import moldiff_tpu_torch.eval as teval

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    names = sorted(f for f in os.listdir(os.path.join(repo, "moldiff_tpu", "eval"))
                   if f.endswith(".py"))
    assert len(names) == 14   # 13 modules and __init__
    for f in names:
        assert os.path.exists(os.path.join(repo, "moldiff_tpu_torch", "eval", f)), f
    def exported(pkg):
        return sorted(n for n in dir(pkg) if not n.startswith("_")
                      and not isinstance(getattr(pkg, n), types.ModuleType))

    assert exported(jeval) == exported(teval)


def test_chip_smoke_demo_settings_are_the_yaml():
    """chip_smoke.py's SAMPLE_DEMO (phase 19, --eval-gate demo30k) is
    configs/sample/sample_demo.yml (the card machine reads no YAML)."""
    import yaml

    import chip_smoke

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "sample", "sample_demo.yml")) as f:
        assert chip_smoke.SAMPLE_DEMO == yaml.safe_load(f)
    assert chip_smoke.EVAL_GATES["demo30k"] == (chip_smoke.SAMPLE_DEMO, "results/demo30k_eval")


def _shifted_bar(tmp_path, column=None, shift=0.0, n_complete=None) -> str:
    """A copy of results/demo30k_eval with one column shifted or fewer
    molecules complete."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / f"bar_{column}_{shift}_{n_complete}")
    shutil.copytree(os.path.join(repo, "results", "demo30k_eval"), out)
    if column:
        with open(os.path.join(out, "mols.csv")) as f:
            rows = list(csv.reader(f))
        j = rows[0].index(column)
        for r in rows[1:]:
            r[j] = repr(float(r[j]) + shift)
        with open(os.path.join(out, "mols.csv"), "w", newline="") as f:
            csv.writer(f, lineterminator="\n").writerows(rows)
    if n_complete is not None:
        with open(os.path.join(out, "validity.json")) as f:
            v = json.load(f)
        v["n_invalid"] += v["n_complete"] - n_complete
        v["n_complete"] = n_complete
        with open(os.path.join(out, "validity.json"), "w") as f:
            json.dump(v, f)
    return out


def test_eval_gate_rule(tmp_path):
    """--eval-gate's rule: the bar against itself passes with the bar's
    numbers (success 256 of 269, Wilson [0.9191, 0.9715]; qed 0.4372, SE
    0.0053; n_hdon zero everywhere); a logP shifted by 0.5 (z about 3.3), a
    success rate of 230 of 269 or an n_hdon of 1 in every row misses."""
    import chip_smoke

    bar = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "results",
                       "demo30k_eval")
    same = chip_smoke.compare_with_bar(bar, bar)
    assert same["passed"]
    k, n, lo, hi = same["success"]["port"]
    assert (k, n, round(lo, 4), round(hi, 4)) == (256, 269, 0.9191, 0.9715)
    assert [round(x, 4) for x in same["qed"]["jax"]] == [0.4372, 0.0053]
    assert same["n_hdon"]["jax"] == [0.0, 0.0] and same["n_hdon"]["z"] == 0.0
    logp = chip_smoke.compare_with_bar(_shifted_bar(tmp_path, "logp", 0.5), bar)
    assert not logp["passed"] and not logp["logp"]["ok"] and 3.2 < logp["logp"]["z"] < 3.4
    assert logp["qed"]["ok"] and logp["success"]["ok"]
    low = chip_smoke.compare_with_bar(_shifted_bar(tmp_path, n_complete=230), bar)
    assert not low["passed"] and not low["success"]["ok"]
    hdon = chip_smoke.compare_with_bar(_shifted_bar(tmp_path, "n_hdon", 1.0), bar)
    assert not hdon["passed"] and hdon["n_hdon"]["z"] == math.inf
