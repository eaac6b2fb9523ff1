"""moldiff_tpu_torch's parameter initialisation against moldiff_tpu's on the
CPU: MolDiff.init_params and BondPredictor.init_params give the JAX
package's tree (keys, shapes, float32) for the same config, with
update_pos on and off and with bond_len_loss; each leaf follows torch
nn.Linear's rule, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), LayerNorm leaves
are 1 and 0; a seed gives one tree; an ungated denoiser has JAX's
ungated tree; and a
state the port initialised and saved loads in the JAX package, whose
forward on it equals the port's at float32. jax.random and torch's
generators differ, so the numbers themselves are not compared."""
import copy
import math

import jax
import numpy as np
import pytest
import torch

from moldiff_tpu.models.bond_predictor import BondPredictor as JBondPredictor
from moldiff_tpu.models.moldiff import MolDiff as JMolDiff
from moldiff_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from moldiff_tpu.utils.config import load_config
from moldiff_tpu_torch.models.bond_predictor import BondPredictor
from moldiff_tpu_torch.models.moldiff import MolDiff
from moldiff_tpu_torch.train.optim import tree_leaves
from moldiff_tpu_torch.train.trainer import Trainer
from moldiff_tpu_torch.utils.checkpoint import params_to_torch
from torch_port_util import max_err, to_np

KN, KE, KE_BOND = 8, 6, 5


def _denoiser_cfg(update_pos: bool = True, bond_len_loss: bool = True) -> dict:
    cfg = copy.deepcopy(load_config("configs/train/train_v2_cont.yml").to_dict()["model"])
    cfg.update(node_dim=64, edge_dim=32, bond_len_loss=bond_len_loss)
    cfg["denoiser"].update(num_blocks=2, dtype="float32", remat=False, update_pos=update_pos)
    return cfg


def _predictor_cfg() -> dict:
    cfg = copy.deepcopy(load_config("configs/train/train_bondpred_demo.yml").to_dict()["model"])
    cfg.update(node_dim=64, edge_dim=32)
    cfg["encoder"].update(num_blocks=2, dtype="float32", remat=False)
    return cfg


CASES = {
    "denoiser": lambda: (JMolDiff, MolDiff, _denoiser_cfg(), KE),
    "denoiser_no_pos": lambda: (JMolDiff, MolDiff, _denoiser_cfg(False, False), KE),
    "bond_predictor": lambda: (JBondPredictor, BondPredictor, _predictor_cfg(), KE_BOND),
}


def _paths(tree) -> list:
    return [(jax.tree_util.keystr(p), tuple(np.shape(x)))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_tree_equals_jax(case):
    """Same keys (and so the same leaf order), shapes and float32 dtype as
    the JAX package's init_params for the config."""
    jcls, tcls, cfg, ke = CASES[case]()
    want = jcls(cfg, KN, ke).init_params(jax.random.key(0))
    got = tcls(cfg, KN, ke, device="cpu").init_params(torch.Generator().manual_seed(0))
    assert _paths(got) == _paths(want)
    assert all(x.dtype == torch.float32 for x in tree_leaves(got))
    blocks = got["encoder" if case == "bond_predictor" else "denoiser"]["blocks"]
    assert ("pos_block" in blocks) == (case == "denoiser")


def _leaf_kinds(tree, path=""):
    """(path, leaf, fan_in or the LayerNorm value) for every leaf."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias"}:
            yield path + "/scale", tree["scale"], 1.0
            yield path + "/bias", tree["bias"], 0.0
            return
        if "w" in tree:
            fan_in = tree["w"].shape[-2]
            for k in ("w", "b"):
                if k in tree:
                    yield f"{path}/{k}", tree[k], fan_in
            return
        for k, v in tree.items():
            yield from _leaf_kinds(v, f"{path}/{k}")
    else:
        for k, v in enumerate(tree):
            yield from _leaf_kinds(v, f"{path}/{k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_distribution(case):
    """Every w and b leaf inside +-1/sqrt(fan_in); on leaves of at least
    4096 elements the mean within 0.05 x 1/sqrt(fan_in) of 0 and the
    standard deviation within 5 % of its uniform value, (1/sqrt(fan_in)) /
    sqrt(3); LayerNorm leaves exactly 1 and 0."""
    _, tcls, cfg, ke = CASES[case]()
    params = tcls(cfg, KN, ke, device="cpu").init_params(torch.Generator().manual_seed(1))
    leaves = list(_leaf_kinds(params))
    assert len(leaves) == len(tree_leaves(params))
    big = 0
    for path, x, kind in leaves:
        if path.endswith(("/scale", "/bias")):
            assert bool((x == kind).all()), path
            continue
        bound = 1.0 / math.sqrt(kind)
        assert float(x.abs().max()) <= bound, path
        if x.numel() >= 4096:
            big += 1
            assert abs(float(x.mean())) <= 0.05 * bound, path
            assert abs(float(x.std()) - bound / math.sqrt(3)) <= 0.05 * bound / math.sqrt(3), path
    assert big >= 5


def test_init_seeded():
    """One generator seed, one tree; another seed, another."""
    cfg = _denoiser_cfg()
    model = MolDiff(cfg, KN, KE, device="cpu")
    a, b, c = (tree_leaves(model.init_params(torch.Generator().manual_seed(s)))
               for s in (3, 3, 4))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, z) for x, z in zip(a, c) if x.std() > 0)


def test_ungated_denoiser_is_refused():
    """No longer refused: an ungated denoiser (``use_gate: false``) builds
    the JAX package's tree, which has no gate leaf."""
    cfg = _denoiser_cfg()
    cfg["denoiser"]["use_gate"] = False
    want = JMolDiff(cfg, KN, KE).init_params(jax.random.key(0))
    got = MolDiff(cfg, KN, KE, device="cpu").init_params(torch.Generator().manual_seed(0))
    assert _paths(got) == _paths(want)
    assert not any("gate" in path for path, _ in _paths(got))


def test_port_initialised_state_loads_in_jax(tmp_path):
    """A from-scratch state saved by the port loads in the JAX package's
    load_checkpoint, and JAX's forward on those params equals the port's at
    float32 (rtol 1e-5 of the outputs' range)."""
    cfg = _denoiser_cfg()
    full = load_config("configs/train/train_v2_cont.yml").to_dict()
    full["model"] = cfg
    model = MolDiff(cfg, KN, KE, device="cpu")
    trainer = Trainer(model, full["train"])
    state = trainer.init_state(torch.Generator().manual_seed(5))
    assert all(torch.equal(p, e) and p.data_ptr() != e.data_ptr()
               for p, e in zip(tree_leaves(state.params), tree_leaves(state.ema_params)))
    path = str(tmp_path / "0.ckpt")
    trainer.save_checkpoint(path, state, full)
    blob = jax_load_checkpoint(path)
    assert blob["step"] == 0 and blob["config"]["model"]["node_dim"] == 64

    rng = np.random.default_rng(0)
    b, n = 2, 10
    mask = np.ones((b, n), np.float32)
    mask[1, 7:] = 0
    e = n * (n - 1) // 2
    h_node = np.eye(KN, dtype=np.float32)[rng.integers(0, KN, (b, n))]
    pos = (rng.normal(size=(b, n, 3)) * 1.5).astype(np.float32)
    h_half = np.eye(KE, dtype=np.float32)[rng.integers(0, KE, (b, e))]
    t = np.array([700, 40], np.int32)
    want = JMolDiff(cfg, KN, KE).forward(blob["params"], h_node, pos, h_half, t, mask)
    got = model.forward(params_to_torch(blob["params"], "cpu"), torch.tensor(h_node),
                        torch.tensor(pos), torch.tensor(h_half), torch.tensor(t).long(),
                        torch.tensor(mask))
    for w, g in zip(want, got):
        w = to_np(w)
        assert max_err(g, w) <= 1e-5 * np.abs(w).max()
