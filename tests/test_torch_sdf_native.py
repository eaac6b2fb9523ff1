"""The port's native SDF parser (moldiff_tpu_torch/native/sdf_parser.cpp,
chem/sdf_native.py) against the JAX package's native parser and against the
Python parser, on tests/test_sdf_native.py's cases: multi-record files,
broken records giving None in the same slots, a file without a final
separator, charges, aromatic bonds and multi-conformer records. It builds
into build/native/<hash>/ at first use; a failed build raises."""
import os

import numpy as np
import pytest

from moldiff_tpu.chem import sdf_native as jnative
from moldiff_tpu.data.dataset import parse_conf_arrays as j_parse_conf_arrays
from moldiff_tpu_torch.chem import sdf_native
from moldiff_tpu_torch.chem.sdf import read_sdf, write_sdf
from moldiff_tpu_torch.data.dataset import parse_conf_arrays, parse_conf_list
from moldiff_tpu_torch.data.synthetic import random_molecule
from moldiff_tpu_torch.data.synthetic_v2 import random_molecule_v2


def _assert_mols_equal(a, b):
    assert a.num_atoms == b.num_atoms and a.num_bonds == b.num_bonds
    for x, y in zip(a.atoms, b.atoms):
        assert x.z == y.z and x.charge == y.charge
        np.testing.assert_allclose(x.pos, y.pos, atol=1e-9)
    for x, y in zip(a.bonds, b.bonds):
        assert (x.i, x.j, x.order) == (y.i, y.j, y.order)


def _assert_arrays_equal(a, b):
    """Two read_sdf_arrays results: None in the same slots, equal arrays of
    equal dtypes elsewhere."""
    assert [r is None for r in a] == [r is None for r in b]
    for x, y in zip(a, b):
        if x is not None:
            assert sorted(x) == sorted(y)
            for k in x:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def _check_file(path, n):
    """The port's parser against JAX's native parser (arrays and Mols) and
    the Python parser (Mols)."""
    if not jnative.native_available():
        pytest.fail("the JAX package's native SDF parser did not build")
    got = sdf_native.read_sdf_arrays(path)
    assert len(got) == n
    _assert_arrays_equal(got, jnative.read_sdf_arrays(path))
    mols, jmols, py = (sdf_native.read_sdf_native(path), jnative.read_sdf_native(path),
                       list(read_sdf(path)))
    assert [m is None for m in mols] == [m is None for m in jmols] == [m is None for m in py]
    for a, b, c in zip(mols, jmols, py):
        if a is not None:
            _assert_mols_equal(a, b)
            _assert_mols_equal(a, c)
    return got, mols


@pytest.mark.parametrize("gen", [random_molecule, random_molecule_v2], ids=["v1", "v2"])
def test_multi_record_file(tmp_path, gen):
    """30 molecules in one file (v2: aromatic bonds, type 4)."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "corpus.sdf")
    write_sdf([gen(rng) for _ in range(30)], path)
    got, _ = _check_file(path, 30)
    if gen is random_molecule_v2:
        assert any((r["bond_type"] == 4).any() for r in got)


def test_charges(tmp_path):
    rng = np.random.default_rng(1)
    mol = random_molecule(rng)
    mol.atoms[0].charge = 1
    mol.atoms[-1].charge = -1
    path = str(tmp_path / "chg.sdf")
    write_sdf([mol], path)
    _, (nat,) = _check_file(path, 1)
    assert nat.atoms[0].charge == 1 and nat.atoms[-1].charge == -1


def test_broken_records_give_none_in_the_same_slots(tmp_path):
    rng = np.random.default_rng(2)
    good = random_molecule(rng)
    path = str(tmp_path / "mix.sdf")
    write_sdf([good], path)
    with open(path, "a") as f:
        f.write("broken\n\n\n  1  0  0  0  0  0  0  0  0  0999 V2000\n")
        f.write("  bad atom line\n")
        f.write("M  END\n$$$$\n")
    write_sdf([good], str(tmp_path / "tail.sdf"))
    with open(path, "a") as f:
        f.write(open(str(tmp_path / "tail.sdf")).read())
    got, _ = _check_file(path, 3)
    assert got[1] is None and got[0] is not None and got[2] is not None


def test_duplicate_bond_gives_none(tmp_path):
    rng = np.random.default_rng(8)
    mol = random_molecule(rng)
    path = str(tmp_path / "dup.sdf")
    write_sdf([mol], path)
    text = open(path).read().splitlines()
    bond_ln = 4 + mol.num_atoms
    text.insert(bond_ln, text[bond_ln])
    counts = text[3]
    text[3] = counts[:3] + f"{mol.num_bonds + 1:>3d}" + counts[6:]
    with open(path, "w") as f:
        f.write("\n".join(text) + "\n")
    got, _ = _check_file(path, 1)
    assert got == [None]


def test_no_trailing_separator(tmp_path):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "tailless.sdf")
    write_sdf([random_molecule(rng)], path)
    content = open(path).read()
    assert content.endswith("$$$$\n")
    with open(path, "w") as f:
        f.write(content[: -len("$$$$\n")])
    _check_file(path, 1)


def test_missing_file():
    with pytest.raises(FileNotFoundError):
        sdf_native.read_sdf_arrays("/nonexistent/x.sdf")


@pytest.mark.parametrize("seed", range(4))
def test_conformer_records_equal_the_python_path(tmp_path, seed):
    """Multi-conformer files: the arrays path gives the Mol path's record
    byte for byte (dtypes included), and JAX's arrays path's."""
    rng = np.random.default_rng(6 + seed)
    mol = random_molecule_v2(rng)
    confs = []
    for _ in range(3):
        c = mol.copy()
        for a in c.atoms:
            a.pos = a.pos + rng.normal(0, 0.05, 3)
        confs.append(c)
    path = str(tmp_path / f"m{seed}.sdf")
    write_sdf(confs, path)
    ref = parse_conf_list(list(read_sdf(path)), molid=seed)
    fast = parse_conf_arrays(sdf_native.read_sdf_arrays(path), molid=seed)
    jfast = j_parse_conf_arrays(jnative.read_sdf_arrays(path), molid=seed)
    for other in (fast, jfast):
        for k in ("element", "pos", "bond_index", "bond_type"):
            assert ref[k].dtype == other[k].dtype and np.array_equal(ref[k], other[k])


def test_build_is_cached_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The library sits under build/native/<hash of source and flags>/; a
    second build() reuses it; a source that does not compile raises with the
    compiler's output (no fallback), and so does a missing compiler."""
    lib = sdf_native.build()
    assert lib == sdf_native.lib_path() and lib.exists()
    assert lib.parent.parent == sdf_native.BUILD_ROOT
    mtime = os.path.getmtime(lib)
    assert sdf_native.build() == lib and os.path.getmtime(lib) == mtime
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(sdf_native, "SOURCE", bad)
    monkeypatch.setattr(sdf_native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="SDF parser build failed"):
        sdf_native.build()
    assert not sdf_native.lib_path().exists()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setattr(sdf_native, "_loaded", None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        sdf_native.build()
    assert sdf_native.native_available() is False
