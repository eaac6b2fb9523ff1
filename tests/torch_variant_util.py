"""Helpers of the tests that hold the port's model variants (MoE, the
continuous categorical space, ungated blocks) to moldiff_tpu on the CPU:
narrow configs over the committed ones, a padded batch, the noise JAX's
get_loss draws from a key, and the loss with every gradient on each side."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from moldiff_tpu.models.bond_predictor import BondPredictor as JBondPredictor
from moldiff_tpu.models.moldiff import MolDiff as JMolDiff
from moldiff_tpu.models.moldiff import sample_time_antithetic as j_antithetic
from moldiff_tpu.utils.config import load_config
from moldiff_tpu_torch.models.bond_predictor import BondLossNoise, BondPredictor
from moldiff_tpu_torch.models.moldiff import LossNoise, MolDiff
from moldiff_tpu_torch.train.optim import tree_leaves, tree_unflatten
from moldiff_tpu_torch.utils.checkpoint import params_to_torch
from torch_port_util import jax_tree, to_np

KN, KE, KE_BOND = 8, 6, 5
B, N = 3, 8
# the continuous space's settings of tests/test_continuous_mode.py
CONTINUOUS = {"categorical_space": "continuous", "scaling": [1.0, 4.0, 8.0]}
MOE = {"num_experts": 4, "top_k": 2}


def denoiser_cfg(dtype: str = "float32", diff: "dict | None" = None, **denoiser) -> dict:
    """configs/train/train_v2_cont.yml's model at node_dim 64, edge_dim 32,
    2 blocks, with ``denoiser`` set on model.denoiser and ``diff`` on
    model.diff."""
    cfg = copy.deepcopy(load_config("configs/train/train_v2_cont.yml").to_dict()["model"])
    cfg.update(node_dim=64, edge_dim=32)
    cfg["denoiser"].update(num_blocks=2, dtype=dtype, remat=False, **denoiser)
    cfg["diff"].update(diff or {})
    return cfg


def predictor_cfg(dtype: str = "float32", **encoder) -> dict:
    """configs/train/train_bondpred_demo.yml's predictor at node_dim 32,
    edge_dim 16, 2 blocks, T = 200, with ``encoder`` set on model.encoder."""
    cfg = copy.deepcopy(load_config("configs/train/train_bondpred_demo.yml").to_dict()["model"])
    cfg.update(node_dim=32, edge_dim=16)
    cfg["encoder"].update(num_blocks=2, dtype=dtype, remat=False, **encoder)
    return cfg


def batch(seed: int = 0, b: int = B, n: int = N, bond_types: int = 5) -> dict:
    """Molecules of n, n - 2 and n - 5 atoms padded to n (numpy)."""
    rng = np.random.default_rng(seed)
    sizes = np.array([n, n - 2, n - 5][:b])
    mask = (np.arange(n)[None] < sizes[:, None]).astype(np.float32)
    iu, ju = np.triu_indices(n, k=1)
    he_mask = mask[:, iu] * mask[:, ju]
    return {"node_type": (rng.integers(0, 7, (b, n)) * mask).astype(np.int32),
            "pos": (rng.normal(size=(b, n, 3)) * 1.5 * mask[..., None]).astype(np.float32),
            "halfedge_type": (rng.integers(0, bond_types, (b, n * (n - 1) // 2))
                              * he_mask).astype(np.int32),
            "node_mask": mask}


def torch_batch(batch: dict) -> dict:
    out = {k: torch.tensor(v) for k, v in batch.items()}
    out["node_type"] = out["node_type"].long()
    out["halfedge_type"] = out["halfedge_type"].long()
    return out


def loss_noise(key, b: int, n: int, continuous: bool = False, num_timesteps: int = 1000):
    """The time draw and noise JAX's MolDiff.get_loss draws from ``key``:
    uniform class noise, or standard normal in the continuous space."""
    k_t, k_pos, k_node, k_edge = jax.random.split(key, 4)
    e = n * (n - 1) // 2
    draw = jax.random.normal if continuous else jax.random.uniform
    as_t = lambda x: torch.tensor(np.asarray(x))
    return LossNoise(t=as_t(j_antithetic(k_t, b, num_timesteps)).long(),
                     pos=as_t(jax.random.normal(k_pos, (b, n, 3), jnp.float32)),
                     node=as_t(draw(k_node, (b, n, KN), jnp.float32)),
                     edge=as_t(draw(k_edge, (b, e, KE), jnp.float32)))


def bond_loss_noise(key, b: int, n: int, num_timesteps: int = 200) -> BondLossNoise:
    """The time draw and noise JAX's BondPredictor.get_loss draws from ``key``."""
    k_t, k_pos, k_node = jax.random.split(key, 3)
    as_t = lambda x: torch.tensor(np.asarray(x))
    return BondLossNoise(t=as_t(j_antithetic(k_t, b, num_timesteps)).long(),
                         pos=as_t(jax.random.normal(k_pos, (b, n, 3), jnp.float32)),
                         node=as_t(jax.random.uniform(k_node, (b, n, KN), jnp.float32)))


def jax_loss_grads(jmodel, params, batch: dict, key):
    """(loss, loss terms, gradient tree) of JAX's get_loss."""
    @jax.jit
    def run(p):
        return jax.value_and_grad(lambda q: jmodel.get_loss(
            q, batch["node_type"], batch["pos"], batch["halfedge_type"], batch["node_mask"],
            key), has_aux=True)(p)
    (loss, aux), grads = run(jax_tree(params))
    return float(loss), {k: float(v) for k, v in aux.items()}, grads


def torch_loss_grads(tmodel, params, batch: dict, noise):
    """(loss, loss terms, gradient list in tree_leaves order) of the port's
    get_loss on the numpy tree ``params``."""
    tp = params_to_torch(params, "cpu")
    leaves = [x.requires_grad_(True) for x in tree_leaves(tp)]
    tb = torch_batch(batch)
    loss, aux = tmodel.get_loss(tree_unflatten(tp, leaves), tb["node_type"], tb["pos"],
                                tb["halfedge_type"], tb["node_mask"], noise)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), {k: float(v.detach()) for k, v in aux.items()}, grads


def assert_grads_close(got, want_tree) -> None:
    """Every gradient leaf within rtol 2e-3 and atol 2e-3 of the leaf's
    largest magnitude of JAX's (tests/test_torch_train.py's bound)."""
    paths = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert len(paths) == len(got)
    for (path, w), g in zip(paths, got):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(to_np(g), w, rtol=2e-3, atol=2e-3 * np.abs(w).max() + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))


def denoiser_pair(cfg: dict):
    """(JAX MolDiff, the port's MolDiff on the CPU) of one config."""
    return JMolDiff(cfg, KN, KE), MolDiff(cfg, KN, KE, device="cpu")


def predictor_pair(cfg: dict):
    return JBondPredictor(cfg, KN, KE_BOND), BondPredictor(cfg, KN, KE_BOND, device="cpu")
