"""moldiff_tpu_torch/data against moldiff_tpu/data: the synthetic
generators molecule for molecule on one seeded stream, the in-memory corpus
against the SDF corpus scripts/make_corpus.py writes, featurize and
pad_mols, and the bucketed loader's batches for the same records and seed."""
import numpy as np
import pytest

from moldiff_tpu.chem.sdf import read_sdf
from moldiff_tpu.data import batching as jbatching
from moldiff_tpu.data.dataset import mol_to_arrays as j_mol_to_arrays
from moldiff_tpu.data.featurize import MolFeaturizer as JFeaturizer
from moldiff_tpu.data.loader import BucketedLoader as JLoader
from moldiff_tpu.data.synthetic import make_synthetic_dataset
from moldiff_tpu.data.synthetic import random_molecule as j_random_molecule
from moldiff_tpu.data.synthetic_v2 import random_molecule_v2 as j_random_molecule_v2
from moldiff_tpu_torch.data import batching, dataset
from moldiff_tpu_torch.data.featurize import MolFeaturizer
from moldiff_tpu_torch.data.loader import BucketedLoader
from moldiff_tpu_torch.data.synthetic import random_molecule
from moldiff_tpu_torch.data.synthetic_v2 import random_molecule_v2

XL2_SEED = 3024     # scripts/make_corpus.py: xl2
N_V2 = 20


def _stream(gen, seed, n):
    rng = np.random.default_rng(seed)
    return [gen(rng) for _ in range(n)]


@pytest.fixture(scope="module")
def v2_pair():
    return (_stream(j_random_molecule_v2, XL2_SEED, N_V2),
            dataset.generate_records(N_V2, XL2_SEED, "v2"))


@pytest.mark.parametrize("k", range(N_V2))
def test_synthetic_v2_equals_jax(v2_pair, k):
    """Molecule k of the xl2 stream: the same elements, bonds (orders
    included, aromatic as 4) and positions as the JAX package's generator."""
    jmols, recs = v2_pair
    want = j_mol_to_arrays(jmols[k])
    got = recs[k]
    assert got["molid"] == f"syn{k:05d}"
    np.testing.assert_array_equal(got["element"], want["element"])
    np.testing.assert_array_equal(got["bond_index"], want["bond_index"])
    np.testing.assert_array_equal(got["bond_type"], want["bond_type"])
    np.testing.assert_array_equal(got["pos"][0], want["pos"])


def test_synthetic_v1_equals_jax():
    """The v1 generator (the v2 generator's fallback), seed 7 (the demo
    corpus), molecule for molecule."""
    want = _stream(j_random_molecule, 7, 8)
    got = _stream(random_molecule, 7, 8)
    for w, g in zip(want, got):
        for key, arr in j_mol_to_arrays(w).items():
            np.testing.assert_array_equal(dataset.mol_to_arrays(g)[key], arr)


def test_v2_falls_back_to_v1(monkeypatch):
    """After 12 rejections the v2 generator returns the v1 generator's
    molecule from the same stream, as the JAX package's does."""
    from moldiff_tpu.data import synthetic_v2 as jv2
    from moldiff_tpu_torch.data import synthetic_v2 as tv2

    def reject(rng, n_atoms):
        rng.random()
        raise tv2._RetryError()

    def jreject(rng, n_atoms):
        rng.random()
        raise jv2._RetryError()

    monkeypatch.setattr(tv2, "_generate", reject)
    monkeypatch.setattr(jv2, "_generate", jreject)
    got = random_molecule_v2(np.random.default_rng(5))
    want = j_random_molecule_v2(np.random.default_rng(5))
    for key, arr in j_mol_to_arrays(want).items():
        np.testing.assert_array_equal(dataset.mol_to_arrays(got)[key], arr)


def test_corpus_equals_the_sdf_corpus(tmp_path):
    """make_corpus's records equal the SDF corpus make_synthetic_dataset
    writes from the same recipe, up to the SDF's 4-decimal positions, with
    the 80/10/10 split by molid order."""
    import pickle

    make_synthetic_dataset(str(tmp_path), n_mols=10, seed=XL2_SEED, chemistry="v2")
    with open(tmp_path / "split_by_molid.pkl", "rb") as f:
        split = pickle.load(f)
    monkey = dict(dataset.CORPORA)
    dataset.CORPORA["./tmp_corpus"] = (10, XL2_SEED, "v2")
    try:
        subsets = dataset.make_corpus("tmp_corpus", 10)
    finally:
        dataset.CORPORA.clear()
        dataset.CORPORA.update(monkey)
    for name in ("train", "val", "test"):
        assert [r["molid"] for r in subsets[name]] == split[name]
    for rec in subsets["train"] + subsets["val"] + subsets["test"]:
        mol = next(read_sdf(str(tmp_path / "sdf" / f"{rec['molid']}.sdf")))
        want = j_mol_to_arrays(mol)
        np.testing.assert_array_equal(rec["element"], want["element"])
        np.testing.assert_array_equal(rec["bond_index"], want["bond_index"])
        np.testing.assert_array_equal(rec["bond_type"], want["bond_type"])
        np.testing.assert_allclose(rec["pos"][0], want["pos"], atol=5.1e-5, rtol=0)


def test_corpus_knows_the_configs_roots():
    assert dataset.CORPORA["./data/synthetic_xl2"] == (96_000, XL2_SEED, "v2")
    with pytest.raises(ValueError, match="no corpus recipe"):
        dataset.make_corpus("./data/elsewhere", 3)


@pytest.mark.parametrize("k", [0, 3])
def test_featurize_and_pad_equal_jax(v2_pair, k):
    """featurize (both bond directions in, half-edges out) and pad_mols into
    a bucket equal the JAX package's."""
    from moldiff_tpu.data.loader import featurize_record as j_featurize_record
    from moldiff_tpu_torch.data.loader import featurize_record

    recs = v2_pair[1][k:k + 3]
    feats = [featurize_record(r, MolFeaturizer(), np.random.default_rng(0)) for r in recs]
    jfeats = [j_featurize_record(r, JFeaturizer(), np.random.default_rng(0)) for r in recs]
    for f, jf in zip(feats, jfeats):
        for key in jf:
            np.testing.assert_array_equal(f[key], jf[key])
    got = batching.pad_mols(feats, n_max=40)
    want = jbatching.pad_mols(jfeats, n_max=40)
    for key in ("node_type", "pos", "halfedge_type", "node_mask", "n_nodes"):
        np.testing.assert_array_equal(got[key], getattr(want, key))
    assert batching.pick_bucket(33, (32, 40)) == jbatching.pick_bucket(33, (32, 40)) == 40


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False), (True, False)])
def test_loader_batches_equal_jax(v2_pair, shuffle, drop_last):
    """The same records, seed and buckets give the same batches, in order,
    as the JAX package's BucketedLoader (one epoch, no prefetch)."""
    recs = v2_pair[1]
    kw = dict(batch_size=3, buckets=(24, 32, 40), shuffle=shuffle, seed=11, infinite=False,
              drop_last=drop_last, prefetch=0)
    got = list(BucketedLoader(recs, MolFeaturizer(), **kw))
    want = list(JLoader(recs, JFeaturizer(), **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])


def test_loader_prefetch_is_the_same_stream(v2_pair):
    """The prefetch thread changes nothing but when batches are made."""
    recs = v2_pair[1]
    kw = dict(batch_size=3, buckets=(24, 32, 40), seed=2, infinite=False)
    a = list(BucketedLoader(recs, MolFeaturizer(), prefetch=0, **kw))
    b = list(BucketedLoader(recs, MolFeaturizer(), prefetch=2, **kw))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for key in x:
            np.testing.assert_array_equal(x[key], y[key])


@pytest.mark.parametrize("bucket", [32, 40])
def test_profile_train_batch_is_a_bucket_of_v2_molecules(bucket):
    """profile_steps --train's batch: v2 molecules at sizes inside the
    bucket's range, padded to the bucket as the JAX package's pad_mols pads
    the same featurized records."""
    import torch

    from moldiff_tpu_torch.data.featurize import featurizer_from_config
    from moldiff_tpu_torch.data.loader import featurize_record
    from moldiff_tpu_torch.sample.profile_steps import TRAIN_SIZES, train_batch
    from moldiff_tpu_torch.train.settings import TRAIN_V2_CONT
    from moldiff_tpu_torch.utils.config import Config

    got = train_batch(TRAIN_V2_CONT, 3, bucket, seed=bucket, dev=torch.device("cpu"))
    sizes = got["node_mask"].sum(1)
    lo, hi = TRAIN_SIZES[bucket]
    assert got["node_mask"].shape == (3, bucket)
    assert bool(((sizes >= lo) & (sizes <= hi)).all())
    rng = np.random.default_rng(bucket)
    recs = dataset.generate_records(3, bucket, "v2",
                                    n_atoms=rng.integers(lo, hi + 1, 3).tolist())
    feat = featurizer_from_config(Config(TRAIN_V2_CONT))
    want = jbatching.pad_mols([featurize_record(r, feat, rng) for r in recs], n_max=bucket)
    for k in ("node_type", "pos", "halfedge_type", "node_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(getattr(want, k)), err_msg=k)


@pytest.mark.parametrize("onehot", [True, False], ids=["one-hots", "class indices"])
def test_split_trajectories_equals_jax(onehot):
    """split_trajectories unpads each molecule's trajectory as JAX's does,
    on one-hot states and on the class indices the port keeps on the
    device."""
    rng = np.random.default_rng(7)
    s, b, n = 4, 3, 9
    e = n * (n - 1) // 2
    node, he = rng.integers(0, 8, (s, b, n)), rng.integers(0, 6, (s, b, e))
    if onehot:
        node, he = np.eye(8, dtype=np.float32)[node], np.eye(6, dtype=np.float32)[he]
    traj = (node, rng.normal(size=(s, b, n, 3)).astype(np.float32), he)
    counts = np.array([9, 4, 6])
    got = batching.split_trajectories(traj, counts)
    want = jbatching.split_trajectories(traj, counts)
    assert len(got) == len(want) == b
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"node", "pos", "halfedge"}
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
