"""moldiff_tpu_torch/data/record_store.py against moldiff_tpu/data/record_store.py:
the port's store read by the JAX package's reader through both of its paths
(its native library and its Python fallback), the JAX package's store read
by the port's, the same bytes for the same records, and the reader's
bounds and hints."""
import filecmp
import os
import pickle

import numpy as np
import pytest

from moldiff_tpu.data import record_store as jstore
from moldiff_tpu_torch.data import record_store as tstore


def _records():
    """Molecule dicts of several sizes, an empty record and raw bytes."""
    rng = np.random.default_rng(0)
    out = []
    for k, n in enumerate((3, 17, 1, 40)):
        out.append({"molid": f"m{k}", "element": rng.integers(1, 17, n).astype(np.int16),
                    "pos": rng.normal(size=(2, n, 3)).astype(np.float32),
                    "bond_index": np.stack([np.arange(n - 1), np.arange(1, n)]).astype(np.int16),
                    "bond_type": np.ones(n - 1, np.int8)})
    return out


RAW = [b"", b"\x00\xffraw bytes", bytes(range(256)) * 3]


def _write(mod, path):
    with mod.RecordWriter(path) as w:
        for r in _records():
            w.append(r)
        for b in RAW:
            w.append_bytes(b)


def _check(reader):
    recs = _records()
    assert len(reader) == len(recs) + len(RAW)
    for i, want in enumerate(recs):
        got = reader[i]
        assert got["molid"] == want["molid"]
        for k in ("element", "pos", "bond_index", "bond_type"):
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    for j, b in enumerate(RAW):
        assert reader.get_bytes(len(recs) + j) == b


@pytest.fixture(params=["native", "python"])
def jax_path(request, monkeypatch):
    """The JAX package's store through its C++ library or, with its loader
    made to find none, through its pure-Python fallback."""
    if request.param == "python":
        monkeypatch.setattr(jstore, "_lib", lambda: None)
    elif jstore._lib() is None:
        pytest.fail("the JAX package's native record store did not build")
    return request.param


def test_port_store_reads_in_jax(tmp_path, jax_path):
    path = str(tmp_path / "port")
    _write(tstore, path)
    r = jstore.RecordReader(path)
    try:
        _check(r)
    finally:
        r.close()


def test_jax_store_reads_in_port(tmp_path, jax_path):
    path = str(tmp_path / "jax")
    _write(jstore, path)
    with tstore.RecordReader(path) as r:
        _check(r)
        assert next(iter(r))["molid"] == "m0"


def test_same_bytes(tmp_path, jax_path):
    """.bin and .idx equal byte for byte for the same records, the empty
    record and raw bytes included."""
    _write(tstore, str(tmp_path / "port"))
    _write(jstore, str(tmp_path / "jax"))
    for ext in (".bin", ".idx"):
        assert filecmp.cmp(tmp_path / f"port{ext}", tmp_path / f"jax{ext}", shallow=False)


def test_append_pickles_like_jax(tmp_path):
    """append(obj) stores pickle.dumps at the highest protocol, and returns
    the record's index."""
    with tstore.RecordWriter(str(tmp_path / "s")) as w:
        assert [w.append(r) for r in _records()] == [0, 1, 2, 3]
    with tstore.RecordReader(str(tmp_path / "s")) as r:
        assert r.get_bytes(1) == pickle.dumps(_records()[1], protocol=pickle.HIGHEST_PROTOCOL)


def test_bounds_prefetch_and_empty_store(tmp_path):
    path = str(tmp_path / "s")
    _write(tstore, path)
    with tstore.RecordReader(path) as r:
        n = len(r)
        for i in (-1, n, n + 5):
            with pytest.raises(IndexError):
                r.get_bytes(i)
        for lo, hi in ((0, n), (2, 3), (n - 1, n + 10), (5, 2), (-3, 1)):
            r.prefetch(lo, hi)
        _check(r)
    with tstore.RecordWriter(str(tmp_path / "empty")):
        pass
    with tstore.RecordReader(str(tmp_path / "empty")) as r:
        assert len(r) == 0 and list(r) == []
    j = jstore.RecordReader(str(tmp_path / "empty"))
    assert len(j) == 0
    j.close()
    assert tstore.using_native() is False


def test_missing_and_corrupt(tmp_path):
    with pytest.raises(FileNotFoundError):
        tstore.RecordReader(str(tmp_path / "nothing"))
    path = str(tmp_path / "s")
    _write(tstore, path)
    with open(path + ".bin", "r+b") as f:
        f.truncate(100)
    with pytest.raises(OSError, match="index"):
        tstore.RecordReader(path)
    with open(path + ".idx", "r+b") as f:
        f.write(b"\x00" * 8)
    with pytest.raises(OSError, match="not a record store"):
        tstore.RecordReader(path)


def test_interrupted_write_leaves_no_store(tmp_path):
    """An exception inside the writer's block drops its temporary files and
    leaves an earlier store at the same path as it was; until close, only
    temporary names exist."""
    path = str(tmp_path / "s")
    _write(tstore, path)
    before = {ext: open(path + ext, "rb").read() for ext in (".bin", ".idx")}
    with pytest.raises(KeyboardInterrupt):
        with tstore.RecordWriter(path) as w:
            w.append_bytes(b"partial")
            raise KeyboardInterrupt
    assert sorted(os.listdir(tmp_path)) == ["s.bin", "s.idx"]
    assert {ext: open(path + ext, "rb").read() for ext in (".bin", ".idx")} == before
    fresh = str(tmp_path / "fresh")
    w = tstore.RecordWriter(fresh)
    w.append_bytes(b"x")
    assert not os.path.exists(fresh + ".bin") and not os.path.exists(fresh + ".idx")
    w.close()
    with tstore.RecordReader(fresh) as r:
        assert r.get_bytes(0) == b"x"
    assert sorted(os.listdir(tmp_path)) == ["fresh.bin", "fresh.idx", "s.bin", "s.idx"]
