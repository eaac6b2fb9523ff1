"""moldiff_tpu_torch's copies of eval/, chem/smarts and chem/embed against
moldiff_tpu's, on the same molecules: each side builds its own Mol from
the same SMILES or SDF block, and the results must be equal (floats to
1e-12)."""
import importlib
import io
import math
import os

import numpy as np
import pytest

from moldiff_tpu.chem import sdf as jsdf
from moldiff_tpu.chem import smiles as jsmi
from moldiff_tpu.chem.mol import AROMATIC
from moldiff_tpu.chem.mol import Mol as JMol
from moldiff_tpu.data.featurize import MolFeaturizer as JFeaturizer
from moldiff_tpu_torch.chem import sdf as tsdf
from moldiff_tpu_torch.chem import smiles as tsmi
from moldiff_tpu_torch.chem.mol import Mol as TMol
from moldiff_tpu_torch.data.featurize import MolFeaturizer as TFeaturizer
from test_torch_chem import SMILES, _random_decoded

# moldiff_tpu.chem exports a function named sanitize over its module
jsan = importlib.import_module("moldiff_tpu.chem.sanitize")
tsan = importlib.import_module("moldiff_tpu_torch.chem.sanitize")


def _mods(name):
    return (importlib.import_module(f"moldiff_tpu.{name}"),
            importlib.import_module(f"moldiff_tpu_torch.{name}"))


jsmarts, tsmarts = _mods("chem.smarts")
jembed, tembed = _mods("chem.embed")
jfp, tfp = _mods("eval.fingerprint")
jsa, tsa = _mods("eval.sa_score")
jdesc, tdesc = _mods("eval.descriptors")
jcrip, tcrip = _mods("eval.crippen")
jalert, talert = _mods("eval.alerts")
jfrag, tfrag = _mods("eval.fragments")
jrmsd, trmsd = _mods("eval.rmsd")
jl3d, tl3d = _mods("eval.local3d")
jmet, tmet = _mods("eval.metrics")
jjsd, tjsd = _mods("eval.jsd")
jsim, tsim = _mods("eval.similarity")
jfail, tfail = _mods("eval.failure_analysis")
jvis, tvis = _mods("eval.visualize")

TOL = 1e-12


def _blocks(generator: str, seed: int, count: int) -> list:
    """SDF blocks of seeded molecules from the JAX package's generators
    (3D positions, charges kept)."""
    if generator == "v1":
        from moldiff_tpu.data.synthetic import random_molecule as gen
    else:
        from moldiff_tpu.data.synthetic_v2 import random_molecule_v2 as gen
    rng = np.random.default_rng(seed)
    return [jsdf.mol_to_molblock(gen(rng)) for _ in range(count)]


# 20 SMILES (no positions) and 10 seeded 3D molecules
MOLS = ([("smiles", s) for s in SMILES]
        + [("sdf", b) for b in _blocks("v1", 31, 5)]
        + [("sdf", b) for b in _blocks("v2", 32, 5)])
IDS = [f"smi{k}" for k in range(len(SMILES))] + [f"v1_{k}" for k in range(5)] + \
    [f"v2_{k}" for k in range(5)]
MOLS_3D = [m for m in MOLS if m[0] == "sdf"]
IDS_3D = [i for i in IDS if not i.startswith("smi")]
# odd molecules (elements without embedding tables, a bare atom pair):
# (element, bond_index, bond_type), 3D positions on a line
ODD = [([5, 6], [[0], [1]], [1]), ([34, 6, 6], [[0, 1], [1, 2]], [1, 1]),
       ([6, 6, 6], [[0, 1], [1, 2]], [AROMATIC, AROMATIC])]


def _build(spec, side: str, sanitize: bool = True):
    kind, data = spec
    smi, sdf, san = (jsmi, jsdf, jsan) if side == "jax" else (tsmi, tsdf, tsan)
    if kind == "smiles":
        mol = smi.mol_from_smiles(data)
    elif kind == "sdf":
        mol = next(iter(sdf.read_sdf(io.StringIO(data + "$$$$\n"))))
    else:
        el, bi, bt = data
        cls = JMol if side == "jax" else TMol
        pos = np.stack([np.arange(len(el)) * 1.5, np.zeros(len(el)), np.zeros(len(el))], 1)
        return cls.from_arrays(np.array(el), pos, np.array(bi), np.array(bt))
    if sanitize:
        san.sanitize(mol)
    return mol


def pair(spec):
    return _build(spec, "jax"), _build(spec, "torch")


def assert_same(a, b, path="out"):
    """Equal nested results: floats to TOL (NaN equal to NaN), arrays and
    everything else exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for k, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{k}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL, equal_nan=True, err_msg=path)
        else:
            np.testing.assert_array_equal(b, a, err_msg=path)
    elif isinstance(a, float):
        assert isinstance(b, float), (path, a, b)
        assert (math.isnan(a) and math.isnan(b)) or abs(a - b) <= TOL, (path, a, b)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


SMARTS_PATTERNS = sorted(set(jalert.ALERTS.values()) | set(jfrag._SMARTS.values())
                         | {"[#6;R2]", "[N;!H0]", "[$(C=O)]~[#7,#8]", "[r5,r6;a]", "C1CC1",
                            "[CX4;H3,H2]", "c:c", "[O-,N+]", "*~*"})


@pytest.mark.parametrize("spec", MOLS, ids=IDS)
def test_smarts_matches(spec):
    """find_matches, count_matches and has_match of the alerts', fr_*
    counters' and a few more patterns; match_paths of Local3D's patterns."""
    a, b = pair(spec)
    for pat in SMARTS_PATTERNS:
        assert jsmarts.find_matches(a, pat) == tsmarts.find_matches(b, pat), pat
        assert jsmarts.count_matches(a, pat) == tsmarts.count_matches(b, pat), pat
        assert jsmarts.has_match(a, pat) == tsmarts.has_match(b, pat), pat
    for pat in jl3d.PREDEFINED_BONDS + jl3d.PREDEFINED_ANGLES + jl3d.PREDEFINED_DIHEDRALS:
        assert jl3d.match_paths(a, pat) == tl3d.match_paths(b, pat), pat


def test_smarts_parse_and_errors():
    for pat in SMARTS_PATTERNS:
        assert repr(jsmarts.parse(pat)) == repr(tsmarts.parse(pat))
    for bad in ("[C", "C(", "C1CC", "[Xx]", ""):
        with pytest.raises(ValueError) as ej:
            jsmarts.parse(bad)
        with pytest.raises(ValueError) as et:
            tsmarts.parse(bad)
        assert str(ej.value) == str(et.value) and type(et.value).__name__ == type(ej.value).__name__


@pytest.mark.parametrize("spec", MOLS, ids=IDS)
def test_fingerprints_bit_equal(spec):
    a, b = pair(spec)
    for radius in (1, 2, 3):
        assert jfp.morgan_fragments(a, radius) == tfp.morgan_fragments(b, radius)
    for n_bits in (512, 2048):
        np.testing.assert_array_equal(jfp.morgan_fingerprint(a, n_bits=n_bits),
                                      tfp.morgan_fingerprint(b, n_bits=n_bits))


def test_fingerprint_similarities():
    fps_j = np.stack([jfp.morgan_fingerprint(pair(s)[0]) for s in MOLS])
    fps_t = np.stack([tfp.morgan_fingerprint(pair(s)[1]) for s in MOLS])
    np.testing.assert_array_equal(fps_j, fps_t)
    assert jfp.pairwise_diversity(fps_j) == tfp.pairwise_diversity(fps_t)
    assert jfp.tanimoto(fps_j[0], fps_j[3]) == tfp.tanimoto(fps_t[0], fps_t[3])
    np.testing.assert_array_equal(jfp.bulk_tanimoto(fps_j[5], fps_j),
                                  tfp.bulk_tanimoto(fps_t[5], fps_t))


@pytest.mark.parametrize("spec", MOLS, ids=IDS)
def test_descriptors(spec):
    """SA, QED, TPSA, Crippen logP, Lipinski and the rest of
    all_descriptors, alerts and the fr_* counters."""
    a, b = pair(spec)
    assert_same(jdesc.all_descriptors(a), tdesc.all_descriptors(b))
    for fn in ("qed", "tpsa", "crippen_logp", "lipinski", "num_hbd", "num_hba",
               "num_rotatable_bonds", "num_aromatic_rings", "num_rings"):
        assert_same(getattr(jdesc, fn)(a), getattr(tdesc, fn)(b), fn)
    assert_same(jsa.sa_score(a), tsa.sa_score(b))
    assert_same(jcrip.logp(a), tcrip.logp(b))
    assert jcrip.atom_types(a) == tcrip.atom_types(b)
    assert jalert.count_alerts(a) == talert.count_alerts(b)
    assert jalert.num_alerts(a) == talert.num_alerts(b)
    assert jalert.passes_alert_filter(a) == talert.passes_alert_filter(b)
    assert jfrag.groups_counts(a) == tfrag.groups_counts(b)
    assert list(jfrag.groups_counts(a)) == jfrag.REFERENCE_FAMILIES == tfrag.REFERENCE_FAMILIES


@pytest.mark.parametrize("spec", MOLS[::3] + MOLS_3D, ids=IDS[::3] + IDS_3D)
def test_embed_conformers_bit_equal(spec):
    """Distance-geometry bounds and conformers: numpy's generator on both
    sides, so one seed gives the same bits."""
    a, b = pair(spec)
    np.testing.assert_array_equal(jembed.bounds_matrix(a), tembed.bounds_matrix(b))
    ca, cb = jembed.generate_conformers(a, 3, seed=5), tembed.generate_conformers(b, 3, seed=5)
    assert len(ca) == len(cb) == 3
    for x, y in zip(ca, cb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("spec", MOLS_3D, ids=IDS_3D)
def test_rmsd(spec):
    a, b = pair(spec)
    pa = np.stack([x.pos for x in a.atoms])
    rot = np.linalg.qr(np.random.default_rng(1).normal(size=(3, 3)))[0]
    q = pa @ rot.T + 0.3 + np.random.default_rng(2).normal(size=pa.shape) * 0.1
    for center in (True, False):
        assert jrmsd.kabsch_rmsd(pa, q, center) == trmsd.kabsch_rmsd(pa, q, center)
    assert_same(jrmsd.best_embedding_rmsd(a, n_conformers=4, seed=3),
                trmsd.best_embedding_rmsd(b, n_conformers=4, seed=3))


@pytest.mark.parametrize("type_", ["length", "angle", "dihedral"])
def test_local3d_calc_frequent(type_):
    mj, mt = zip(*(pair(s) for s in MOLS_3D))
    lj, lt = jl3d.Local3D(), tl3d.Local3D()
    lj.get_predefined()
    lt.get_predefined()
    got_j, got_t = lj.calc_frequent(mj, type_), lt.calc_frequent(mt, type_)
    assert sum(len(v) for v in got_j.values()) > 0
    assert_same(got_j, got_t)


def test_jsd():
    rng = np.random.default_rng(5)
    a, b = rng.normal(1.5, 0.1, 300), rng.normal(1.52, 0.12, 200)
    assert_same(jjsd.hist_jsd(a, b, bin_width=0.02), tjsd.hist_jsd(a, b, bin_width=0.02))
    ia, ib = rng.integers(10, 30, 100), rng.integers(12, 35, 80)
    assert_same(jjsd.hist_jsd(ia, ib, discrete=True), tjsd.hist_jsd(ia, ib, discrete=True))
    assert_same(jjsd.hist_jsd([], ib, discrete=True), tjsd.hist_jsd([], ib, discrete=True))
    ca, cb = {"C": 10, "N": 3, "O": 2}, {"C": 8, "O": 5, "S": 1}
    assert_same(jjsd.counter_jsd(ca, cb), tjsd.counter_jsd(ca, cb))
    assert_same(jjsd.counter_jsd({}, {}), tjsd.counter_jsd({}, {}))
    gen = {"c:c": rng.normal(1.39, 0.02, 50), "C-C": rng.normal(1.53, 0.03, 40)}
    ref = {"c:c": rng.normal(1.40, 0.02, 60), "C-C": rng.normal(1.52, 0.03, 30),
           "C=O": rng.normal(1.22, 0.02, 20)}
    for type_ in ("length", "angle", "dihedral"):
        assert_same(jjsd.local3d_jsd(gen, ref, type_), tjsd.local3d_jsd(gen, ref, type_))


def test_similarity_analysis(tmp_path):
    """Uniqueness, novelty, similarity to train and val, diversity; and
    the cache each writes loads in the other."""
    mj, mt = zip(*(pair(s) for s in MOLS))
    gen_j, gen_t = list(mj[:12]) + [mj[0]], list(mt[:12]) + [mt[0]]
    sj = jsim.SimilarityAnalysis(train_mols=mj[8:24], val_mols=mj[24:])
    st = tsim.SimilarityAnalysis(train_mols=mt[8:24], val_mols=mt[24:])
    assert_same(sj.all_metrics(gen_j), st.all_metrics(gen_t))
    assert_same(jsim.SimilarityAnalysis().all_metrics(gen_j),
                tsim.SimilarityAnalysis().all_metrics(gen_t))
    cache = str(tmp_path / "sim.pkl")
    jsim.SimilarityAnalysis(train_mols=mj[8:24], val_mols=mj[24:], cache_path=cache)
    assert_same(sj.all_metrics(gen_j), tsim.SimilarityAnalysis(cache_path=cache).all_metrics(gen_t))


def decoded_of(spec) -> dict:
    """The decoder's output for a molecule: elements, positions, bonds."""
    m = _build(spec, "jax", sanitize=False)
    bonds = sorted((min(b.i, b.j), max(b.i, b.j), b.order) for b in m.bonds)
    return {"element": np.array([a.z for a in m.atoms], np.int64),
            "atom_pos": np.stack([a.pos for a in m.atoms]).astype(np.float32),
            "bond_index": np.array([[b[0] for b in bonds], [b[1] for b in bonds]], np.int64),
            "bond_type": np.array([b[2] for b in bonds], np.int64)}


def _random_pool(n: int):
    """Decoded dicts of random decoder outputs (mostly failing), of the
    seeded 3D molecules (complete) and of pairs of them side by side
    (disconnected, the second shifted by 2 or 6 A)."""
    out = []
    for seed in range(n):
        node, pos, he = _random_decoded(seed, 6 + seed % 10)
        dj = JFeaturizer().decode_output(node, pos, he)
        dt = TFeaturizer().decode_output(node, pos, he)
        for k in dj:
            np.testing.assert_array_equal(dj[k], dt[k])
        out.append(dj)
    out += [decoded_of(spec) for spec in MOLS_3D]
    whole = out[-len(MOLS_3D):]
    for k, (a, b) in enumerate(zip(whole[:4], whole[1:5])):
        shift = np.array([2.0 + 4.0 * (k % 2) + np.ptp(a["atom_pos"][:, 0]), 0.0, 0.0],
                         np.float32)
        out.append({"element": np.concatenate([a["element"], b["element"]]),
                    "atom_pos": np.concatenate([a["atom_pos"], b["atom_pos"] + shift]),
                    "bond_index": np.concatenate([a["bond_index"],
                                                  b["bond_index"] + len(a["element"])], 1),
                    "bond_type": np.concatenate([a["bond_type"], b["bond_type"]])})
    return out


@pytest.mark.parametrize("mode", ["reference", "repo"])
def test_calculate_validity(mode):
    pool = _random_pool(30)
    got_j = jmet.calculate_validity(pool, sanitize_mode=mode)
    assert got_j["n_complete"] > 0 and got_j["n_invalid"] > 0 and got_j["n_disconnect"] > 0
    assert_same(got_j, tmet.calculate_validity(pool, sanitize_mode=mode))


def test_failure_analysis():
    from moldiff_tpu.sample.pipeline import classify_decoded as jclassify

    pool = {"finished": [], "failed": []}
    for d in _random_pool(40):
        e = jclassify(d)
        pool[e["pool"]].append({k: v for k, v in e.items() if k != "mol"})
    assert any(e["reason"] == "disconnect" for e in pool["failed"])
    assert_same(jfail.analyze_pool(pool), tfail.analyze_pool(pool))
    assert_same(jfail.analyze_pool(pool, bond_gap=1.0), tfail.analyze_pool(pool, bond_gap=1.0))
    for e in pool["failed"]:
        assert_same(jfail.disconnect_autopsy(e["decoded"]), tfail.disconnect_autopsy(e["decoded"]))
        n = len(e["decoded"]["element"])
        assert jfail.fragment_split(n, e["decoded"]["bond_index"]) == \
            tfail.fragment_split(n, e["decoded"]["bond_index"])


def test_ring_analyzer_and_signatures():
    mj, mt = zip(*(pair(s) for s in MOLS))
    for k in (3, 10):
        assert jmet.RingAnalyzer().get_freq_rings(mj, topk=k) == \
            tmet.RingAnalyzer().get_freq_rings(mt, topk=k)
    for a, b in zip(mj, mt):
        assert [jmet.ring_signature(a, r) for r in a.ring_info()] == \
            [tmet.ring_signature(b, r) for r in b.ring_info()]


def test_visualize(tmp_path):
    mj, mt = zip(*(pair(s) for s in MOLS_3D[:4]))
    for a, b in zip(mj, mt):
        assert jvis.mol_summary_text(a) == tvis.mol_summary_text(b)
    assert jvis.HAS_MPL == tvis.HAS_MPL
    paths = {}
    for side, vis, mols in (("jax", jvis, mj), ("torch", tvis, mt)):
        paths[side] = (str(tmp_path / f"{side}_one.png"), str(tmp_path / f"{side}_grid.png"))
        assert vis.show_mol(mols[0], paths[side][0]) == jvis.HAS_MPL
        assert vis.show_mols_grid(list(mols), paths[side][1], cols=2) == jvis.HAS_MPL
    if jvis.HAS_MPL:
        for pj, pt in zip(paths["jax"], paths["torch"]):
            with open(pj, "rb") as f, open(pt, "rb") as g:
                assert f.read() == g.read()


FAMILIES = ["drug_chem", "count_prop", "frags_counts", "groups_counts", "ring_topo",
            "global_3d"]


@pytest.mark.parametrize("family", FAMILIES)
def test_get_metric_rows(family):
    """get_metric row by row: the dicts equal key for key, and the same
    rows empty on both sides (a metric that raises gives an empty row,
    which mols.csv shows as zeros). global_3d (100 re-embeddings each) on
    the odd molecules, whose elements it has no tables for, and one 3D
    molecules."""
    specs = ([("odd", o) for o in ODD] + MOLS_3D[:1]) if family == "global_3d" else \
        MOLS + [("odd", o) for o in ODD]
    mj = [_build(s, "jax") for s in specs]
    mt = [_build(s, "torch") for s in specs]
    got_j, got_t = jmet.get_metric(mj, family), tmet.get_metric(mt, family)
    assert [i for i, d in enumerate(got_j) if not d] == [i for i, d in enumerate(got_t) if not d]
    if family == "global_3d":
        assert not got_j[0] and got_j[-1]   # boron: no embedding table
    assert_same(got_j, got_t)


PARALLEL_CHILD = r"""
import json, sys
from moldiff_tpu_torch.chem.sanitize import sanitize
from moldiff_tpu_torch.chem.smiles import mol_from_smiles
from moldiff_tpu_torch.eval.metrics import get_metric
mols = [sanitize(mol_from_smiles(s)) for s in json.loads(sys.argv[1])]
print(json.dumps({f: get_metric(mols, f, parallel=True, n_workers=2)
                  for f in ("drug_chem", "ring_topo")}))
"""


def test_get_metric_parallel():
    """The worker pool (more than 32 molecules) gives JAX's serial rows;
    run, as the eval CLI runs it, in a process without torch's or JAX's
    threads (the pool forks)."""
    import json
    import subprocess
    import sys

    smiles = (SMILES * 2)[:36]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", PARALLEL_CHILD, json.dumps(smiles)], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    mj = [_build(("smiles", s), "jax") for s in smiles]
    for family, rows in got.items():
        assert_same(jmet.get_metric(mj, family), rows)


def test_sa_table_is_the_committed_one(monkeypatch, tmp_path):
    """The port's default scorer reads moldiff_tpu/eval/data's table by
    path and scores as JAX's does; without the file it raises instead of
    scoring with an empty table."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert tsa._SHIPPED_TABLE == os.path.join(repo, "moldiff_tpu", "eval", "data",
                                              "fragment_scores_synthetic.pkl")
    monkeypatch.setattr(tsa, "_DEFAULT_SCORER", None)
    table = tsa._default_scorer().scores
    assert len(table) > 1000 and table == jsa._default_scorer().scores
    monkeypatch.setattr(tsa, "_DEFAULT_SCORER", None)
    monkeypatch.setattr(tsa, "_SHIPPED_TABLE", str(tmp_path / "missing.pkl"))
    with pytest.raises(FileNotFoundError):
        tsa._default_scorer()
    with pytest.raises(FileNotFoundError):
        tsa.sa_score(_build(MOLS[0], "torch"))
    # a fitted table and an explicit scorer behave as JAX's
    mj, mt = zip(*(pair(s) for s in MOLS))
    fj, ft = jsa.FragmentScorer.fit(mj), tsa.FragmentScorer.fit(mt)
    assert fj.scores == ft.scores
    for a, b in zip(mj, mt):
        assert_same(jsa.sa_score(a, fj), tsa.sa_score(b, ft))
