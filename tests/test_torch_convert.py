"""moldiff_tpu_torch/utils/convert.py against moldiff_tpu/utils/convert.py:
the reference module tree that tests/test_convert.py builds from torch.nn,
converted by both, gives equal trees leaf for leaf; the exports of the
same params are equal name for name, and each package's export converts
back in the other to the original params; load_reference_checkpoint reads
a torch.save'd checkpoint whose config is an EasyDict, without the easydict
package."""
import pickle
import sys
import types

import jax
import numpy as np
import pytest
import torch

from moldiff_tpu.models.bond_predictor import BondPredictor as JBondPredictor
from moldiff_tpu.models.moldiff import MolDiff as JMolDiff
from moldiff_tpu.utils import convert as jconvert
from moldiff_tpu.utils.config import Config as JConfig
from moldiff_tpu_torch.models.moldiff import MolDiff
from moldiff_tpu_torch.utils import convert
from moldiff_tpu_torch.utils.config import Config
from test_convert import build_reference_moldiff_modules
from torch_port_util import np_tree, to_np

MODEL = {
    "name": "diffusion", "node_dim": 16, "edge_dim": 8,
    "denoiser": {"backbone": "NodeEdgeNet", "num_blocks": 2, "cutoff": 10, "use_gate": True},
    "diff": {"num_timesteps": 8, "time_dim": 4, "categorical_space": "discrete",
             "diff_pos": {"beta_schedule": "advance", "scale_start": 0.9999,
                          "scale_end": 0.0001, "width": 3},
             "diff_atom": {"init_prob": "tomask", "beta_schedule": "advance",
                           "scale_start": 0.9999, "scale_end": 0.0001, "width": 3},
             "diff_bond": {"init_prob": "absorb", "beta_schedule": "advance",
                           "scale_start": 0.9999, "scale_end": 0.0001, "width": 3}},
}
BOND_MODEL = {
    "name": "bond_predictor", "node_dim": 16, "edge_dim": 8,
    "encoder": {"backbone": "NodeEdgeNet", "num_blocks": 2, "cutoff": 20, "use_gate": True,
                "update_edge": True, "update_pos": False},
    "diff": {"num_timesteps": 8, "time_dim": 4, "categorical_space": "discrete",
             "diff_pos": {"beta_schedule": "advance", "scale_start": 0.9999,
                          "scale_end": 0.0001, "width": 3},
             "diff_atom": {"init_prob": "tomask", "beta_schedule": "advance",
                           "scale_start": 0.9999, "scale_end": 0.0001, "width": 3}},
}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for k, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _assert_trees_equal(port, ref):
    """Same paths; each port leaf a float32 tensor equal to the reference's
    leaf bit for bit."""
    got, want = dict(_leaves(port)), dict(_leaves(ref))
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], torch.Tensor) and got[k].dtype == torch.float32, k
        assert np.array_equal(to_np(got[k]), np.asarray(want[k], dtype=np.float32)), k


def test_reference_modules_convert_like_jax():
    """The reference MolDiff module tree (torch.nn) -> the same tree from
    both converters, the layout of the port's init_params."""
    sd = build_reference_moldiff_modules().state_dict()
    port = convert.convert_moldiff_state_dict(sd, Config(MODEL), device="cpu")
    _assert_trees_equal(port, np_tree(jconvert.convert_moldiff_state_dict(sd, JConfig(MODEL))))
    init = MolDiff(MODEL, 8, 6, device="cpu").init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _leaves(port)} == \
        {k: tuple(v.shape) for k, v in _leaves(init)}


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sd = build_reference_moldiff_modules().state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.convert_moldiff_state_dict(sd, Config(MODEL))


@pytest.mark.parametrize("kind", ["moldiff", "bond_predictor"])
def test_export_round_trips_both_ways(kind):
    """Random params: the port's export equals JAX's name for name; the
    port converts JAX's export back to the params, and JAX the port's."""
    if kind == "moldiff":
        params = np_tree(JMolDiff(JConfig(MODEL), 8, 6).init_params(jax.random.key(3)))
        exp, jexp = convert.export_moldiff_state_dict, jconvert.export_moldiff_state_dict
        back, jback = convert.convert_moldiff_state_dict, jconvert.convert_moldiff_state_dict
        cfg = MODEL
    else:
        params = np_tree(JBondPredictor(JConfig(BOND_MODEL), 8, 5).init_params(jax.random.key(4)))
        exp = convert.export_bond_predictor_state_dict
        jexp = jconvert.export_bond_predictor_state_dict
        back = convert.convert_bond_predictor_state_dict
        jback = jconvert.convert_bond_predictor_state_dict
        cfg = BOND_MODEL
    tparams = jax.tree.map(torch.tensor, params)
    sd, jsd = exp(tparams), jexp(params)
    assert sorted(sd) == sorted(jsd)
    for k in sd:
        assert sd[k].dtype == jsd[k].dtype == np.float32 and np.array_equal(sd[k], jsd[k]), k
    _assert_trees_equal(back(jsd, Config(cfg), device="cpu"), params)
    _assert_trees_equal(jax.tree.map(torch.tensor, np_tree(jback(sd, JConfig(cfg)))), params)


@pytest.fixture
def easydict_pickle(tmp_path, monkeypatch):
    """A reference checkpoint saved where easydict was installed (a module
    of that name holding an EasyDict), read where it is not."""
    mod = types.ModuleType("easydict")

    class EasyDict(dict):
        def __getattr__(self, k):
            return self[k]

    EasyDict.__module__, EasyDict.__qualname__ = "easydict", "EasyDict"
    mod.EasyDict = EasyDict
    monkeypatch.setitem(sys.modules, "easydict", mod)
    cfg = EasyDict(model=EasyDict(MODEL), train=EasyDict(seed=1, buckets=[16, 24]))
    ref = build_reference_moldiff_modules()
    path = str(tmp_path / "ref.pt")
    torch.save({"config": cfg, "model": ref.state_dict(), "iteration": 7}, path)
    monkeypatch.delitem(sys.modules, "easydict")
    return path, ref


def test_load_reference_checkpoint_with_easydict_config(easydict_pickle):
    path, ref = easydict_pickle
    sd, cfg = convert.load_reference_checkpoint(path)
    jsd, jcfg = jconvert.load_reference_checkpoint(path)
    assert isinstance(cfg, Config) and cfg.to_dict() == jcfg.to_dict()
    assert cfg.model.denoiser.num_blocks == 2 and cfg.train.buckets == [16, 24]
    assert sorted(sd) == sorted(jsd) == sorted(ref.state_dict())
    for k in sd:
        assert np.array_equal(sd[k], jsd[k])
    _assert_trees_equal(convert.convert_moldiff_state_dict(sd, cfg.model, device="cpu"),
                        np_tree(jconvert.convert_moldiff_state_dict(jsd, jcfg.model)))


@pytest.mark.parametrize("ema_only,f16", [(False, False), (True, False), (False, True)])
def test_strip_checkpoint_like_jax(tmp_path, ema_only, f16):
    """scripts/strip_checkpoint.py's distribution checkpoint: the same
    fields and leaves; the port's optimizer state (extra["optimizer"]) goes
    too; the JAX loader reads the port's file."""
    from moldiff_tpu.train.trainer import load_checkpoint as j_load_checkpoint
    from moldiff_tpu_torch.utils import strip_checkpoint as strip
    from scripts.strip_checkpoint import strip_checkpoint as j_strip

    params = np_tree(JMolDiff(JConfig(MODEL), 8, 6).init_params(jax.random.key(5)))
    ema = jax.tree.map(lambda x: x * 0.5, params)
    blob = {"config": {"model": MODEL}, "params": params, "ema_params": ema, "step": 12,
            "opt_state": None, "scheduler": {"best": 1.0}, "key": None,
            "extra": {"optimizer": {"count": 12, "mu": params}, "note": "kept"}}
    src = str(tmp_path / "train.ckpt")
    with open(src, "wb") as f:
        pickle.dump(blob, f)
    args = [src, str(tmp_path / "dist.ckpt")] + (["--ema_only"] if ema_only else []) \
        + (["--f16"] if f16 else [])
    strip.main(args)
    got = j_load_checkpoint(str(tmp_path / "dist.ckpt"))
    want = j_strip(blob, ema_only=ema_only, f16=f16)
    assert got["step"] == want["step"] == 12 and got["config"] == want["config"]
    assert got["opt_state"] is got["scheduler"] is got["key"] is None
    assert got["extra"] == {"note": "kept"}
    for key in ("params", "ema_params"):
        if want[key] is None:
            assert got[key] is None
            continue
        for (p, a), (_, b) in zip(_leaves(got[key]), _leaves(want[key])):
            assert np.array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32)), p
    raw = strip.strip_checkpoint(dict(blob, ema_params=None), f16=True)
    assert next(iter(dict(_leaves(raw["params"])).values())).dtype == np.float16
    with pytest.raises(ValueError, match="ema_params"):
        strip.strip_checkpoint(dict(blob, ema_params=None), ema_only=True)
