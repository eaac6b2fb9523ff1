"""moldiff_tpu_torch/utils/checkpoint.py and utils/config.py: every leaf of
every committed checkpoint as moldiff_tpu loads it, the pickle-global
mapping, and params carried across from the JAX package's init."""
import glob
import pickle

import jax
import numpy as np
import pytest
import torch

from moldiff_tpu.models.denoiser import init_node_block
from moldiff_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from moldiff_tpu.utils.config import Config as JConfig
from moldiff_tpu.utils.config import load_config as jax_load_config
from moldiff_tpu_torch.utils import checkpoint as tck
from moldiff_tpu_torch.utils.config import Config, load_config

CKPTS = sorted(glob.glob("ckpts/*.ckpt"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_six_checkpoints_committed():
    assert len(CKPTS) == 6


@pytest.mark.parametrize("path", CKPTS)
def test_checkpoint_leaf_by_leaf(path):
    """Same leaves, shapes, float32 upcast and values; same config and step."""
    want = jax_load_checkpoint(path)
    got = tck.load_checkpoint(path, device="cpu")
    assert isinstance(got["config"], Config)
    assert got["config"].to_dict() == JConfig(want["config"]).to_dict()
    assert got["step"] == want["step"]
    for key in ("params", "ema_params"):
        if want.get(key) is None:
            assert key not in got
            continue
        w, g = dict(_leaves(want[key])), dict(_leaves(got[key]))
        assert w.keys() == g.keys()
        for name in w:
            assert isinstance(g[name], torch.Tensor), name
            assert g[name].dtype == torch.from_numpy(np.asarray(w[name])).dtype, name
            np.testing.assert_array_equal(g[name].numpy(), np.asarray(w[name]), err_msg=name)


def test_numpy_core_mapping():
    """numpy 1 has numpy.core where numpy 2 writes numpy._core."""
    m = tck.map_global
    assert m("numpy._core.numeric", "_frombuffer", False) == ("numpy.core.numeric", "_frombuffer")
    assert m("numpy._core", "dtype", False) == ("numpy.core", "dtype")
    assert m("numpy._core.numeric", "_frombuffer", True) == ("numpy._core.numeric", "_frombuffer")
    assert m("numpy", "dtype", False) == ("numpy", "dtype")
    assert m("moldiff_tpu.utils.config", "Config", True) == \
        ("moldiff_tpu_torch.utils.config", "Config")


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_load_through_numpy_core_names():
    """Loading with the numpy 1 names gives the same params."""
    a = tck.load_checkpoint_numpy("ckpts/demo_synthetic_30k.ckpt", numpy_core=True)
    b = tck.load_checkpoint_numpy("ckpts/demo_synthetic_30k.ckpt", numpy_core=False)
    for (ka, va), (kb, vb) in zip(_leaves(a["params"]), _leaves(b["params"])):
        assert ka == kb
        np.testing.assert_array_equal(va, vb)


def test_unmapped_jax_package_global_is_refused(tmp_path):
    """Any other moldiff_tpu global would import the JAX package: refused."""
    from moldiff_tpu.chem.mol import Atom

    path = tmp_path / "bad.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"params": {}, "config": {}, "x": Atom(6)}, f)
    with pytest.raises(pickle.UnpicklingError, match="moldiff_tpu.chem.mol"):
        tck.load_checkpoint_numpy(str(path))


def test_params_from_jax_init():
    """params_to_torch carries a tree straight from the JAX package's init
    functions across unchanged, in the JAX layout (w is [in, out])."""
    params = {"node_block": init_node_block(jax.random.key(0), 32, 16, 32, use_gate=True)}
    tp = tck.params_to_torch(params, "cpu")
    w, g = dict(_leaves(params)), dict(_leaves(tp))
    assert w.keys() == g.keys()
    for name in w:
        np.testing.assert_array_equal(g[name].numpy(), np.asarray(w[name]), err_msg=name)
    assert tuple(tp["node_block"]["gate"]["layers"][0]["lin"]["w"].shape) == (16 + 32 + 1, 32)


def test_config_copy_matches():
    got = load_config("configs/sample/sample_flagship_v2.yml")
    want = jax_load_config("configs/sample/sample_flagship_v2.yml")
    assert got.to_dict() == want.to_dict()
    assert got.sample.commit == "nodes"
    merged = got.merged({"sample": {"commit": "none"}})
    assert merged.sample.commit == "none" and merged.sample.seed == got.sample.seed
