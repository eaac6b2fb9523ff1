"""moldiff_tpu_torch's ungated denoisers (``use_gate: false``) against
moldiff_tpu on the CPU, at float32: MolDiff's loss and every gradient and
the bond predictor's, against jax.value_and_grad; the route (no kernel
wrapper is called: JAX takes its kernels only where ``"gate" in p``, and
fuse_block is switched off); and an ungated reference state dict through
utils/convert.py, converted as JAX converts it, whose forward equals JAX's.
Outputs within rtol 1e-5 / atol 1e-5, gradients within 2e-3 of each
leaf's scale."""
import jax
import numpy as np
import pytest
import torch

from moldiff_tpu.models.moldiff import MolDiff as JMolDiff
from moldiff_tpu.utils import convert as jconvert
from moldiff_tpu.utils.config import Config as JConfig
from moldiff_tpu_torch.models.moldiff import MolDiff
from moldiff_tpu_torch.ops import kernels
from moldiff_tpu_torch.utils import convert
from moldiff_tpu_torch.utils.config import Config
from moldiff_tpu_torch.utils.checkpoint import params_to_torch
from test_convert import build_reference_moldiff_modules
from test_torch_convert import MODEL, _assert_trees_equal
from torch_port_util import np_tree, to_np
from torch_variant_util import (B, N, assert_grads_close, batch, bond_loss_noise, denoiser_cfg,
                                denoiser_pair, jax_loss_grads, loss_noise, predictor_cfg,
                                predictor_pair, torch_batch, torch_loss_grads)

TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_WRAPPERS = ("node_block_aggregate", "edge_pair_aggregate", "pos_update", "fused_block",
                   "edge_block_full")


@pytest.fixture(scope="module")
def ungated():
    jm, tm = denoiser_pair(denoiser_cfg(use_gate=False))
    return jm, tm, np_tree(jm.init_params(jax.random.key(0)))


def test_loss_and_gradients_equal_jax(ungated):
    """MolDiff.get_loss of an ungated denoiser: every term and every
    gradient against jax.value_and_grad; its tree has no gate leaf."""
    jm, tm, params = ungated
    assert "gate" not in params["denoiser"]["blocks"]["node_block"]
    data, key = batch(0), jax.random.key(7)
    loss_j, aux_j, grads_j = jax_loss_grads(jm, params, data, key)
    loss_t, aux_t, grads_t = torch_loss_grads(tm, params, data, loss_noise(key, B, N))
    assert set(aux_t) == set(aux_j)
    for k in aux_j:
        assert aux_t[k] == pytest.approx(aux_j[k], rel=1e-5, abs=1e-6), k
    assert_grads_close(grads_t, grads_j)


def test_bond_predictor_loss_and_gradients_equal_jax():
    jm, tm = predictor_pair(predictor_cfg(use_gate=False))
    params = np_tree(jm.init_params(jax.random.key(2)))
    data, key = batch(1, bond_types=5), jax.random.key(3)
    loss_j, aux_j, grads_j = jax_loss_grads(jm, params, data, key)
    loss_t, aux_t, grads_t = torch_loss_grads(tm, params, data, bond_loss_noise(key, B, N))
    assert set(aux_t) == set(aux_j) == {"loss", "loss_edge", "acc_bond"}
    for k in aux_j:
        assert aux_t[k] == pytest.approx(aux_j[k], rel=1e-5, abs=1e-6), k
    assert_grads_close(grads_t, grads_j)


@pytest.mark.parametrize("flags", [{}, {"fuse_block": True}, {"edge_full": True}])
def test_ungated_route_calls_no_kernel(ungated, monkeypatch, flags):
    """No kernel wrapper is called in a loss and its backward, whatever the
    route flags say."""
    _, _, params = ungated
    calls = []
    for fn in KERNEL_WRAPPERS:
        monkeypatch.setattr(kernels, fn, lambda *a, _n=fn, **k: calls.append(_n))
    _, tm = denoiser_pair(denoiser_cfg(use_gate=False, **flags))
    assert not tm.denoiser_static["use_gate"]
    tb = torch_batch(batch(0))
    tp = params_to_torch(params, "cpu")
    leaves = [x.requires_grad_(True) for x in jax.tree.leaves(tp)]
    loss, _ = tm.get_loss(tp, tb["node_type"], tb["pos"], tb["halfedge_type"], tb["node_mask"],
                          loss_noise(jax.random.key(1), B, N))
    torch.autograd.grad(loss, leaves)
    assert calls == []


def test_ungated_reference_state_dict_loads_and_runs():
    """The reference module tree without its gate modules converts, in the
    port as in JAX, to the same ungated tree (the layout of the port's
    init_params), and the port's forward on it equals JAX's."""
    cfg = dict(MODEL, denoiser=dict(MODEL["denoiser"], use_gate=False))
    sd = {k: v for k, v in build_reference_moldiff_modules().state_dict().items()
          if ".gate." not in k}
    port = convert.convert_moldiff_state_dict(sd, Config(cfg), device="cpu")
    want = jconvert.convert_moldiff_state_dict(sd, JConfig(cfg))
    _assert_trees_equal(port, np_tree(want))
    init = MolDiff(cfg, 8, 6, device="cpu").init_params(torch.Generator().manual_seed(0))
    assert sorted(map(tuple, (x.shape for x in jax.tree.leaves(init)))) == \
        sorted(map(tuple, (x.shape for x in jax.tree.leaves(port))))
    rng = np.random.default_rng(0)
    b, n = 2, 9
    e = n * (n - 1) // 2
    mask = (np.arange(n)[None] < np.array([[9], [5]])).astype(np.float32)
    h_node = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (b, n))]
    pos = (rng.normal(size=(b, n, 3)) * 1.5).astype(np.float32)
    h_half = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (b, e))]
    t = np.array([6, 1], np.int32)
    ref = JMolDiff(JConfig(cfg), 8, 6).forward(want, h_node, pos, h_half, t, mask)
    got = MolDiff(cfg, 8, 6, device="cpu").forward(
        port, *map(torch.tensor, (h_node, pos, h_half)), torch.tensor(t).long(),
        torch.tensor(mask))
    for g, w in zip(got, ref):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)
