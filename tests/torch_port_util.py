"""Helpers of the tests that hold moldiff_tpu_torch against moldiff_tpu:
numpy trees in, one tree for each framework out."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from moldiff_tpu_torch.utils.checkpoint import params_to_torch


def np_tree(tree):
    """A JAX params tree -> the same nesting of float32 numpy arrays."""
    return jax.tree.map(lambda x: np.asarray(x, dtype=np.float32), tree)


def jax_tree(tree, dtype=jnp.float32):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype=dtype), tree)


def torch_tree(tree, dtype=torch.float32):
    return jax.tree.map(lambda x: x.to(dtype), params_to_torch(tree, "cpu"))


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def max_err(a, b) -> float:
    return float(np.abs(to_np(a) - to_np(b)).max())


TRAIN_CONFIGS = sorted(str(p) for p in (Path(__file__).resolve().parent.parent
                                        / "configs" / "train").glob("*.yml"))


def config_blocks(path: str) -> dict:
    """The shapes of the block weights (node_block, edge_block; leading axis
    the blocks) of the model a train config defines, denoiser or bond
    predictor, through the JAX package's init without computing it."""
    from moldiff_tpu.models import MolDiff
    from moldiff_tpu.models.bond_predictor import BondPredictor
    from moldiff_tpu.utils import load_config

    cfg = load_config(path).model
    cls = BondPredictor if cfg.get("name") == "bond_predictor" else MolDiff
    shapes = jax.eval_shape(lambda: cls(cfg, 8, 6).init_params(jax.random.key(0)))
    return shapes["encoder" if cls is BondPredictor else "denoiser"]["blocks"]
