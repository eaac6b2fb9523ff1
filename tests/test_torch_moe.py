"""moldiff_tpu_torch's mixture-of-experts NodeBlock (models/moe.py) against
moldiff_tpu's on the CPU, at float32: the routed MLP (top-1 and top-2),
padding invariance, capacity dropping, the aux loss under a uniform router,
the config's validation, a MoE node_block, MolDiff's and the bond
predictor's loss with loss_moe and every gradient against
jax.value_and_grad, one reverse step against JAX's scan body, the init
tree and its distribution, and the route: no NodeBlock kernel (row 1) and
no whole-block kernel (row 2) under MoE, the EdgeBlock and PosUpdate
kernels as without it; a MoE checkpoint through the sample CLI and the
server's service. Outputs within rtol 1e-5 / atol 1e-5, gradients
within 2e-3 of each leaf's scale."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models import denoiser as jden
from moldiff_tpu.models import moe as jmoe
from moldiff_tpu.models.moldiff import MolDiffPreds as JPreds
from moldiff_tpu_torch.models import denoiser as tden
from moldiff_tpu_torch.models import moe as tmoe
from moldiff_tpu_torch.models.moldiff import SampleState, StepNoise
from moldiff_tpu_torch.ops import kernels
from moldiff_tpu_torch.train.optim import tree_leaves
from moldiff_tpu_torch.utils.checkpoint import params_to_torch
from torch_port_util import np_tree, to_np
from torch_variant_util import (B, KE, KN, MOE, N, assert_grads_close, batch, bond_loss_noise,
                                denoiser_cfg, denoiser_pair, jax_loss_grads, loss_noise,
                                predictor_cfg, predictor_pair, torch_loss_grads)

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(**kw):
    return jmoe.normalize_moe_cfg({"num_experts": 4, "top_k": 1, "capacity_factor": 8.0, **kw})


def _bank(seed: int, din: int = 6, dout: int = 5, hidden: int = 8, experts: int = 4):
    return np_tree(jmoe.init_moe_mlp(jax.random.key(seed), din, dout, hidden, experts))


def _both(p, x, mask, cfg):
    want = jmoe.moe_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(mask), cfg)
    got = tmoe.moe_mlp(params_to_torch(p, "cpu"), torch.tensor(x), torch.tensor(mask), cfg)
    return want, got


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_equals_jax(top_k):
    """The routed output and the aux loss of moe_mlp equal JAX's on a padded
    batch with capacity to spare and with JAX's default capacity (1.25,
    some tokens dropped)."""
    rng = np.random.default_rng(top_k)
    x = rng.normal(size=(3, 9, 6)).astype(np.float32)
    mask = (np.arange(9)[None] < np.array([[9], [6], [2]])).astype(np.float32)
    for factor in (8.0, 1.25):
        (yw, aw), (yg, ag) = _both(_bank(top_k), x, mask, _cfg(top_k=top_k,
                                                               capacity_factor=factor))
        np.testing.assert_allclose(to_np(yg), np.asarray(yw), **TOL)
        assert float(ag) == pytest.approx(float(aw), rel=1e-5)


def test_padding_invariance():
    """Extra masked atoms change no real output and get exactly zero."""
    rng = np.random.default_rng(4)
    p = params_to_torch(_bank(4), "cpu")
    cfg = _cfg(top_k=2)
    x = torch.tensor(rng.normal(size=(3, 5, 6)).astype(np.float32))
    y_small, _ = tmoe.moe_mlp(p, x, torch.ones(3, 5), cfg)
    x_pad = torch.cat([x, torch.tensor(rng.normal(size=(3, 4, 6)).astype(np.float32))], dim=1)
    mask_pad = torch.cat([torch.ones(3, 5), torch.zeros(3, 4)], dim=1)
    y_pad, _ = tmoe.moe_mlp(p, x_pad, mask_pad, cfg)
    np.testing.assert_allclose(y_pad[:, :5].numpy(), y_small.numpy(), **TOL)
    assert float(y_pad[:, 5:].abs().max()) == 0.0


def test_capacity_dropping():
    """A zero router sends every token to expert 0; at capacity 1 only the
    first token is kept (equal to the ample run's), the rest get exactly
    zero, as in JAX."""
    p = _bank(7, experts=2)
    p["router"]["w"] = np.zeros_like(p["router"]["w"])
    x = np.random.default_rng(8).normal(size=(1, 8, 6)).astype(np.float32)
    mask = np.ones((1, 8), np.float32)
    _, (ample, _) = _both(p, x, mask, _cfg(num_experts=2, capacity_factor=8.0))
    (tight_j, _), (tight, _) = _both(p, x, mask, _cfg(num_experts=2, capacity_factor=0.25))
    np.testing.assert_allclose(tight[0, 0].numpy(), ample[0, 0].numpy(), **TOL)
    assert float(tight[0, 1:].abs().max()) == 0.0
    np.testing.assert_allclose(tight.numpy(), np.asarray(tight_j), **TOL)


def test_uniform_router_aux_is_one():
    p = params_to_torch(_bank(9), "cpu")
    p["router"]["w"] = torch.zeros_like(p["router"]["w"])
    x = torch.tensor(np.random.default_rng(10).normal(size=(2, 8, 6)).astype(np.float32))
    _, aux = tmoe.moe_mlp(p, x, torch.ones(2, 8), _cfg())
    assert float(aux) == pytest.approx(1.0, rel=1e-5)


def test_cfg_validation():
    """normalize_moe_cfg gives JAX's dict (defaults filled) and refuses what
    JAX refuses."""
    for moe in (None, {}, {"num_experts": 8}, MOE, {"top_k": 2, "capacity_factor": 2,
                                                      "aux_weight": 0.1}):
        assert tmoe.normalize_moe_cfg(moe) == jmoe.normalize_moe_cfg(moe)
    for bad in ({"num_experts": 4, "top_k": 3}, {"num_experts": 1}):
        with pytest.raises(ValueError):
            tmoe.normalize_moe_cfg(bad)
    assert tden.denoiser_static_config(num_blocks=1, cutoff=10, use_gate=True,
                                       moe=MOE)["moe"] == jmoe.normalize_moe_cfg(MOE)


def test_moe_node_block_equals_jax():
    """A gated node_block whose node MLP is an expert bank (JAX's plain
    path, the only one JAX takes under MoE) and its aux loss, on a padded
    batch."""
    dn, de = 32, 16
    cfg = jmoe.normalize_moe_cfg(MOE)
    p = np_tree(jden.init_node_block(jax.random.key(3), dn, de, dn, True, moe=cfg))
    rng = np.random.default_rng(3)
    mask = (np.arange(N)[None] < np.array([[8], [6], [3]])).astype(np.float32)
    pair = mask[:, :, None] * mask[:, None, :] * (1 - np.eye(N, dtype=np.float32))
    x = rng.normal(size=(B, N, dn)).astype(np.float32)
    e = rng.normal(size=(B, N, N, de)).astype(np.float32)
    t = rng.uniform(size=(B, 1, 1)).astype(np.float32)
    want, aux_w = jden.node_block(jax.tree.map(jnp.asarray, p), x, e, t, pair, node_mask=mask,
                                  moe_cfg=cfg)
    got, aux_g = tden.node_block(params_to_torch(p, "cpu"), *map(torch.tensor, (x, e, t, pair)),
                                 node_mask=torch.tensor(mask), moe_cfg=cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux_g) == pytest.approx(float(aux_w), rel=1e-5)


@pytest.fixture(scope="module")
def moe_model():
    cfg = denoiser_cfg(moe=MOE)
    jm, tm = denoiser_pair(cfg)
    return jm, tm, np_tree(jm.init_params(jax.random.key(0)))


def test_moe_loss_and_gradients_equal_jax(moe_model):
    """MolDiff.get_loss with the expert bank: every term (loss_moe, the
    load-balance loss x 0.01, included) and every parameter gradient (the
    router's and the experts' included) against jax.value_and_grad."""
    jm, tm, params = moe_model
    data, key = batch(0), jax.random.key(7)
    loss_j, aux_j, grads_j = jax_loss_grads(jm, params, data, key)
    loss_t, aux_t, grads_t = torch_loss_grads(tm, params, data, loss_noise(key, B, N))
    assert set(aux_t) == set(aux_j) and "loss_moe" in aux_t and aux_t["loss_moe"] > 0
    for k in aux_j:
        assert aux_t[k] == pytest.approx(aux_j[k], rel=1e-5, abs=1e-6), k
    assert loss_t == pytest.approx(loss_j, rel=1e-5)
    assert_grads_close(grads_t, grads_j)
    router = grads_j["denoiser"]["blocks"]["node_block"]["node_net"]["router"]["w"]
    assert float(jnp.abs(router).max()) > 0


def test_moe_bond_predictor_loss_equals_jax():
    """The bond predictor with a MoE encoder: loss, loss_edge, acc_bond and
    loss_moe, and every gradient, against jax.value_and_grad."""
    jm, tm = predictor_pair(predictor_cfg(moe=MOE))
    params = np_tree(jm.init_params(jax.random.key(2)))
    data, key = batch(1, bond_types=5), jax.random.key(3)
    loss_j, aux_j, grads_j = jax_loss_grads(jm, params, data, key)
    loss_t, aux_t, grads_t = torch_loss_grads(tm, params, data, bond_loss_noise(key, B, N))
    assert set(aux_t) == set(aux_j) == {"loss", "loss_edge", "acc_bond", "loss_moe"}
    for k in aux_j:
        assert aux_t[k] == pytest.approx(aux_j[k], rel=1e-5, abs=1e-6), k
    assert_grads_close(grads_t, grads_j)


def test_moe_reverse_step_equals_jax(moe_model):
    """One reverse step (commit nodes) of the MoE model, its forward
    included, equals JAX's scan body given the noise JAX draws from the
    step's key: positions and predictions to 1e-5, the sampled classes."""
    jm, tm, params = moe_model
    b, n = B, N
    e = n * (n - 1) // 2
    rng = np.random.default_rng(5)
    mask = batch(0)["node_mask"]
    node = np.eye(KN, dtype=np.float32)[rng.integers(0, KN, (b, n))]
    edge = np.eye(KE, dtype=np.float32)[rng.integers(0, KE, (b, e))]
    pos = (rng.normal(size=(b, n, 3)) * 2).astype(np.float32)
    log_node, log_edge = (np.log(np.clip(x, 1e-30, None)) for x in (node, edge))
    com_node = np.full((b, n), -1)
    step, key = 400, jax.random.key(11)
    body = jm._make_scan_body(jax.tree.map(jnp.asarray, params), jnp.asarray(mask), None, None,
                              False, commit="nodes")
    zero = JPreds(jnp.zeros((b, n, KN)), jnp.zeros((b, n, 3)), jnp.zeros((b, e, KE)))
    carry = tuple(map(jnp.asarray, (pos, node, edge, log_node, log_edge))) + (
        (jnp.asarray(com_node, jnp.int32), jnp.full((b, e), -1, jnp.int32)), zero, key)
    (pos_j, node_j, edge_j, *_, preds_j, _), _ = body(carry, step)
    _, k_pos, k_node, k_edge = jax.random.split(key, 4)
    as_t = lambda x: torch.tensor(np.asarray(x))
    noise = StepNoise(as_t(jax.random.normal(k_pos, (b, n, 3), jnp.float32)),
                      as_t(jax.random.uniform(k_node, (b, n, KN), jnp.float32)),
                      as_t(jax.random.uniform(k_edge, (b, e, KE), jnp.float32)))
    state = SampleState(*map(torch.tensor, (pos, node, edge, log_node, log_edge)),
                        torch.tensor(com_node).long())
    out = tm.reverse_step(params_to_torch(params, "cpu"), state, step, torch.tensor(mask), noise,
                          commit="nodes")
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(pos_j), **TOL)
    np.testing.assert_array_equal(out.h_node.numpy(), np.asarray(node_j))
    np.testing.assert_array_equal(out.h_halfedge.numpy(), np.asarray(edge_j))
    for g, w in zip(out.preds, preds_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _paths(tree) -> list:
    return [(jax.tree_util.keystr(p), tuple(np.shape(x)))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _linear_leaves(tree):
    """(w or b leaf, fan_in) of every linear layer of a tree."""
    if isinstance(tree, dict):
        if "w" in tree:
            yield from ((tree[k], tree["w"].shape[-2]) for k in ("w", "b") if k in tree)
            return
        tree = list(tree.values())
    for v in tree:
        if isinstance(v, (dict, list)):
            yield from _linear_leaves(v)


def test_moe_init_tree_and_distribution():
    """init_params with the bank gives JAX's tree (keys, shapes, float32;
    the router bias-free, the experts stacked [blocks, E, ...]), each w and
    b inside +-1/sqrt(fan_in), the experts' first layers spread as
    U(+-1/sqrt(fan_in)), and one seed one tree."""
    cfg = denoiser_cfg(moe=MOE)
    jm, tm = denoiser_pair(cfg)
    want = jm.init_params(jax.random.key(0))
    got = tm.init_params(torch.Generator().manual_seed(0))
    assert _paths(got) == _paths(want)
    assert all(x.dtype == torch.float32 for x in tree_leaves(got))
    net = got["denoiser"]["blocks"]["node_block"]["node_net"]
    assert set(net["router"]) == {"w"} and net["router"]["w"].shape == (2, 64, 4)
    for x, fan_in in _linear_leaves(got):
        assert float(x.abs().max()) <= 1 / math.sqrt(fan_in)
    w0 = net["experts"]["layers"][0]["lin"]["w"]
    bound = 1 / math.sqrt(64)
    assert abs(float(w0.std()) - bound / math.sqrt(3)) <= 0.05 * bound / math.sqrt(3)
    assert abs(float(w0.mean())) <= 0.05 * bound
    again = tm.init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(again)))


def test_moe_route_runs_no_node_block_kernel(moe_model, monkeypatch):
    """Under MoE the NodeBlock calls no kernel wrapper (JAX passes
    use_pallas and moe_cfg is None) and fuse_block is off; the EdgeBlock and
    PosUpdate wrappers run once a block, as without MoE."""
    jm, _, params = moe_model
    calls = {}
    for fn in ("node_block_aggregate", "edge_pair_aggregate", "pos_update", "fused_block",
               "edge_block_full"):
        orig = getattr(kernels, fn)
        monkeypatch.setattr(kernels, fn, lambda *a, _f=orig, _n=fn, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _f(*a, **k))[1])
    data = batch(0)
    from torch_variant_util import torch_batch
    tb = torch_batch(data)
    for flags, want in (({}, {"edge_pair_aggregate": 2, "pos_update": 2}),
                        ({"fuse_block": True}, {"edge_pair_aggregate": 2, "pos_update": 2}),
                        ({"edge_full": True}, {"edge_block_full": 2, "pos_update": 2})):
        _, tm = denoiser_pair(denoiser_cfg(moe=MOE, **flags))
        calls.clear()
        with torch.no_grad():
            tm.get_loss(params_to_torch(params, "cpu"), tb["node_type"], tb["pos"],
                        tb["halfedge_type"], tb["node_mask"], loss_noise(jax.random.key(1), B, N))
        assert calls == want, (flags, calls)


def test_sample_cli_and_server_on_a_moe_checkpoint(moe_model, tmp_path):
    """A MoE checkpoint the port's trainer wrote samples through the sample
    CLI's run() and the server's service (respaced chains), the denoiser
    rebuilt from the checkpoint's config with its expert bank."""
    from moldiff_tpu_torch.sample import cli
    from moldiff_tpu_torch.serve import SamplerService
    from moldiff_tpu_torch.train.trainer import Trainer
    from moldiff_tpu_torch.utils.config import load_config

    _, tm, params = moe_model
    full = load_config("configs/train/train_v2_cont.yml").to_dict()
    full["model"] = denoiser_cfg(moe=MOE)
    trainer = Trainer(tm, full["train"])
    path = str(tmp_path / "moe.ckpt")
    trainer.save_checkpoint(path, trainer.init_from_params(params_to_torch(params, "cpu")), full)
    sample = {"seed": 1, "batch_size": 4, "num_mols": 1, "num_steps": 2, "commit": "nodes",
              "buckets": [16], "size_mean": 9.0, "size_std": 1.0}
    summary = cli.run({"model": {"checkpoint": path}, "sample": sample}, device="cpu",
                      outdir=str(tmp_path), log=lambda m: None)
    assert summary["chains"] >= 1 and summary["num_steps"] == 2
    sampler, sparams = cli.build_sampler(path, sample, torch.device("cpu"), batch_size=2)
    assert sampler.model.denoiser_static["moe"] == jmoe.normalize_moe_cfg(MOE)
    served = SamplerService(sampler, sparams).generate(1, seed=0)
    assert served["seed"] == 0 and isinstance(served["smiles"], list)
