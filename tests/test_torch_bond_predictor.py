"""moldiff_tpu_torch's BondPredictor against moldiff_tpu's on the committed
bondpred_v2 weights (8 blocks, node_dim 256, edge_dim 64): the checkpoint
loads leaf for leaf, and the forward agrees at B = 2, N = 32 and 40, with
padded molecules, in float32 (to summation order) and bf16 (within 2x the
JAX bf16 forward's own error against float32)."""
import jax
import numpy as np
import pytest
import torch

from moldiff_tpu.models.bond_predictor import BondPredictor as JBondPredictor
from moldiff_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from moldiff_tpu_torch.models.bond_predictor import BondPredictor
from moldiff_tpu_torch.sample.cli import load_bond_predictor
from moldiff_tpu_torch.data.featurize import featurizer_from_config
from moldiff_tpu_torch.utils.checkpoint import load_checkpoint
from torch_port_util import max_err, to_np

PATH = "ckpts/bondpred_v2.ckpt"
KN, KE = 8, 5   # atom types with the mask class; bond types + "none", no mask


@pytest.fixture(scope="module")
def bondpred():
    return jax_load_checkpoint(PATH), load_checkpoint(PATH, device="cpu")


def test_weights_load_leaf_for_leaf(bondpred):
    """Every leaf of the port's load equals the JAX package's load."""
    ck_j, ck_t = bondpred
    jl = jax.tree_util.tree_flatten_with_path(ck_j["params"])[0]
    tl = jax.tree_util.tree_flatten_with_path(ck_t["params"])[0]
    assert [p for p, _ in jl] == [p for p, _ in tl] and len(jl) > 50
    for (path, a), (_, b) in zip(jl, tl):
        assert b.dtype == torch.float32, path
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.numpy(), err_msg=str(path))


def test_sampling_builds_it_without_the_mask_class(bondpred):
    """The CLI's loader: num_edge_types = num_bond_types + 1."""
    feat = featurizer_from_config(load_checkpoint("ckpts/flagship_v2.ckpt", "cpu")["config"])
    bp, params = load_bond_predictor(PATH, feat, torch.device("cpu"))
    assert bp.num_edge_types == KE == feat.num_bond_types + 1
    assert bp.encoder_static["num_blocks"] == 8 and not bp.encoder_static["update_pos"]


def _inputs(n):
    rng = np.random.default_rng(n)
    node_mask = np.zeros((2, n), np.float32)
    node_mask[0, :n - 9] = 1
    node_mask[1, :] = 1
    return dict(node=np.eye(KN, dtype=np.float32)[rng.integers(0, KN, (2, n))],
                pos=(rng.normal(size=(2, n, 3)) * 2).astype(np.float32),
                t=np.array([500, 10], np.int32), mask=node_mask)


def _model_cfg(ck, dtype):
    cfg = dict(ck["config"]["model"])
    cfg["encoder"] = dict(cfg["encoder"], dtype=dtype, remat=False)
    return cfg


def _forward(bondpred, n, dtype):
    ck_j, ck_t = bondpred
    i = _inputs(n)
    jb = JBondPredictor(_model_cfg(ck_j, dtype), KN, KE)
    want = jb.forward(ck_j["params"], i["node"], i["pos"], i["t"], i["mask"])
    tb = BondPredictor(_model_cfg(ck_t, dtype), KN, KE, device="cpu")
    got = tb.forward(ck_t["params"], torch.tensor(i["node"]), torch.tensor(i["pos"]),
                     torch.tensor(i["t"]).long(), torch.tensor(i["mask"]))
    return to_np(want), to_np(got)


@pytest.mark.parametrize("n", [32, 40])
def test_forward_f32_and_bf16(bondpred, n):
    """float32: to 1e-5 of the logits' range. bf16 compute: error against
    the float32 JAX forward within 2x that of the JAX bf16 forward."""
    want32, got32 = _forward(bondpred, n, "float32")
    assert got32.shape == want32.shape == (2, n * (n - 1) // 2, KE)
    assert max_err(got32, want32) <= 1e-5 * np.abs(want32).max()
    want16, got16 = _forward(bondpred, n, "bfloat16")
    assert np.isfinite(got16).all()
    assert max_err(got16, want32) <= 2 * max_err(want16, want32)
