"""moldiff_tpu_torch's copies of chem/, featurize decoding, unpadding and
classification against moldiff_tpu's, on the same inputs."""
import importlib

import numpy as np
import pytest

from moldiff_tpu.chem import sdf as jsdf
from moldiff_tpu.chem import smiles as jsmi
from moldiff_tpu.chem.mol import MolError as JMolError
from moldiff_tpu.data import batching as jbat
from moldiff_tpu.data.featurize import MolFeaturizer as JFeaturizer
from moldiff_tpu.sample.pipeline import classify_decoded as jclassify
from moldiff_tpu_torch.chem import sdf as tsdf
from moldiff_tpu_torch.chem import smiles as tsmi
from moldiff_tpu_torch.chem.mol import MolError as TMolError
from moldiff_tpu_torch.data import batching as tbat
from moldiff_tpu_torch.data.featurize import MolFeaturizer as TFeaturizer
from moldiff_tpu_torch.sample.pipeline import classify_decoded as tclassify

# moldiff_tpu.chem exports a function named sanitize over its module
jsan = importlib.import_module("moldiff_tpu.chem.sanitize")
tsan = importlib.import_module("moldiff_tpu_torch.chem.sanitize")

# the round-trip inputs of tests/test_smiles_parser.py TestRoundTrip, then more
SMILES = [
    "CC(=O)Nc1ccc(O)cc1", "Cn1cnc2c1c(=O)n(C)c(=O)n2C", "CN1CCCC1c1cccnc1", "C[N+](C)(C)C",
    "CCO", "c1ccccc1", "c1ccncc1", "c1cc[nH]c1", "CC(=O)Oc1ccccc1C(=O)O",
    "CN1C=NC2=C1C(=O)N(C(=O)N2C)C", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "O=C1CCCN1",
    "c1ccc2ccccc2c1", "C#CCN", "FC(F)(F)c1ccc(Cl)cc1", "CS(=O)(=O)N", "c1ccsc1", "O=P(O)(O)O",
    "c1ccc2[nH]ccc2c1", "CC1=CC(=O)C=CC1=O",
]


@pytest.mark.parametrize("smi", SMILES)
def test_smiles_round_trip_and_sanitize(smi):
    """Parse, sanitize, write canonical SMILES and an SDF block: the copies
    give the same strings."""
    a, b = jsmi.mol_from_smiles(smi), tsmi.mol_from_smiles(smi)
    assert jsmi.mol_to_smiles(a) == tsmi.mol_to_smiles(b)
    assert jsmi.mol_to_smiles(jsan.sanitize(a)) == tsmi.mol_to_smiles(tsan.sanitize(b))
    assert jsdf.mol_to_molblock(a) == tsdf.mol_to_molblock(b)


def test_random_molecules_round_trip():
    """The JAX chem tests' random molecules (test_smiles_parser.py): the
    port parses the JAX package's SMILES and writes the same string."""
    from moldiff_tpu.data.synthetic import random_molecule

    rng = np.random.default_rng(11)
    for _ in range(100):
        s1 = jsmi.mol_to_smiles(random_molecule(rng))
        assert tsmi.mol_to_smiles(tsmi.mol_from_smiles(s1)) == s1


def _random_decoded(seed, n):
    """A decoder output of random logits: mostly invalid molecules, which
    exercise every stage of the fix cascade."""
    rng = np.random.default_rng(seed)
    e = n * (n - 1) // 2
    node = rng.normal(size=(n, 8)) * 2
    node[:, 0] += 2.5  # mostly carbon, as generated pools are
    he = rng.normal(size=(e, 6)) * 2
    he[:, 0] += 3.5    # mostly no bond
    pos = rng.normal(size=(n, 3)) * 1.5
    return node.astype(np.float32), pos.astype(np.float32), he.astype(np.float32)


@pytest.mark.parametrize("seed", range(12))
def test_decode_reconstruct_classify(seed):
    """decode_output, reconstruct_from_generated (mode reference) and
    classify_decoded agree with the JAX package's."""
    node, pos, he = _random_decoded(seed, 6 + seed)
    dj = JFeaturizer().decode_output(node, pos, he)
    dt = TFeaturizer().decode_output(node, pos, he)
    assert dj.keys() == dt.keys()
    for k in dj:
        np.testing.assert_array_equal(dj[k], dt[k])
    try:
        want = jsmi.mol_to_smiles(jsan.reconstruct_from_generated(
            dj["element"], dj["atom_pos"], dj["bond_index"], dj["bond_type"], mode="reference"))
    except JMolError:
        want = "error"
    try:
        got = tsmi.mol_to_smiles(tsan.reconstruct_from_generated(
            dt["element"], dt["atom_pos"], dt["bond_index"], dt["bond_type"], mode="reference"))
    except TMolError:
        got = "error"
    assert got == want
    cj, ct = jclassify(dj), tclassify(dt)
    assert (cj["pool"], cj.get("reason"), cj.get("smiles"), cj.get("stage")) == \
        (ct["pool"], ct.get("reason"), ct.get("smiles"), ct.get("stage"))


def test_unpad_and_masks():
    rng = np.random.default_rng(4)
    counts = np.array([5, 8, 3])
    arrays = {"pred_node": rng.normal(size=(3, 8, 8)), "pred_pos": rng.normal(size=(3, 8, 3)),
              "pred_halfedge": rng.normal(size=(3, 28, 6))}
    for a, b in zip(jbat.unpad_arrays(arrays, counts), tbat.unpad_arrays(arrays, counts)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(jbat.node_mask_from_counts(counts, 8),
                                  tbat.node_mask_from_counts(counts, 8))
    assert jbat.DEFAULT_BUCKETS == tbat.DEFAULT_BUCKETS
