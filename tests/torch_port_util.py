"""Helpers of the tests that hold moldiff_tpu_torch against moldiff_tpu:
numpy trees in, one tree for each framework out."""
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
