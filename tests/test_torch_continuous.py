"""moldiff_tpu_torch's continuous categorical space
(``diff.categorical_space: continuous``, scaling [1, 4, 8] as
tests/test_continuous_mode.py) against moldiff_tpu on the CPU, at float32:
add_noise on class indices, the loss (MSE to the scaled one-hots x 30) and
every gradient against jax.value_and_grad, one reverse step with the noise
passed in, unguided and guided, against the states of JAX's sampler, the
respaced transitions, the refusal of edge_guidance (the port's one
departure: JAX ignores it), that commit and pos_sampler are not read, a
traced chain that decodes, and the sample CLI on a continuous checkpoint.
Outputs within rtol 1e-5 / atol 1e-5, gradients within 2e-3 of each
leaf's scale."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.ops.gaussian import GaussianTransition as JGaussian
from moldiff_tpu.ops.schedules import get_beta_schedule
from moldiff_tpu_torch.models.moldiff import StepNoise
from moldiff_tpu_torch.ops.gaussian import GaussianTransition
from moldiff_tpu_torch.sample import cli
from moldiff_tpu_torch.utils.checkpoint import load_checkpoint_numpy, params_to_torch
from torch_port_util import np_tree
from torch_variant_util import (B, CONTINUOUS, KE, KN, N, assert_grads_close, batch,
                                denoiser_cfg, denoiser_pair, jax_loss_grads, loss_noise,
                                predictor_cfg, predictor_pair, torch_loss_grads)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def cont_model():
    jm, tm = denoiser_pair(denoiser_cfg(diff=CONTINUOUS))
    return jm, tm, np_tree(jm.init_params(jax.random.key(0)))


def test_add_noise_on_classes():
    """add_noise on class indices returns (x_t, one-hot / scaling); at t = 0
    x_t stays near x0, and given JAX's noise it equals JAX's x_t."""
    betas = get_beta_schedule(num_timesteps=1000, beta_schedule="advance", scale_start=0.9999,
                              scale_end=0.0001, width=3)
    jt, tt = JGaussian(betas, num_classes=KN, scaling=4.0), GaussianTransition(
        betas, num_classes=KN, scaling=4.0)
    v = np.array([[0, 3, 7, 1, 1]], np.int32)
    for t in (0, 500):
        key = jax.random.key(3 + t)
        pert_j, x0_j = jt.add_noise(jnp.asarray(v), jnp.full((1,), t, jnp.int32), key)
        noise = torch.tensor(np.asarray(jax.random.normal(key, (1, 5, KN), jnp.float32)))
        pert, x0 = tt.add_noise(torch.tensor(v).long(), torch.full((1,), t), noise)
        np.testing.assert_allclose(x0.numpy(), np.asarray(x0_j), **TOL)
        np.testing.assert_allclose(pert.numpy(), np.asarray(pert_j), **TOL)
        if t == 0:
            assert float(x0[0, 0, 0]) == 0.25
            np.testing.assert_allclose(pert.numpy(), x0.numpy(), atol=0.15)


def test_loss_and_gradients_equal_jax(cont_model):
    """The continuous loss terms (positions, 30 x each one-hot MSE, bond
    length) and every gradient against jax.value_and_grad, given the
    normal noise JAX draws."""
    jm, tm, params = cont_model
    data, key = batch(0), jax.random.key(7)
    loss_j, aux_j, grads_j = jax_loss_grads(jm, params, data, key)
    loss_t, aux_t, grads_t = torch_loss_grads(tm, params, data,
                                              loss_noise(key, B, N, continuous=True))
    assert set(aux_t) == set(aux_j) == {"loss", "loss_pos", "loss_node", "loss_edge", "loss_len"}
    for k in aux_j:
        assert aux_t[k] == pytest.approx(aux_j[k], rel=1e-5, abs=1e-6), k
    assert_grads_close(grads_t, grads_j)


def test_respaced_transitions_equal_jax(cont_model):
    """All three respaced transitions are Gaussian (the class ones with
    their scaling), coefficients within 1e-6 of JAX's, and t_map equal."""
    jm, tm, _ = cont_model
    (jpos, jnode, jedge), jmap = jm._respaced(50, 1.0)
    trs, tmap = tm._respaced(50, 1.0)
    np.testing.assert_array_equal(tmap, np.asarray(jmap))
    for jt, tt in zip((jpos, jnode, jedge), trs):
        assert isinstance(tt, GaussianTransition)
        assert (tt.num_classes, tt.scaling) == (jt.num_classes, jt.scaling)
        for name in ("alphas_bar", "coef_x0", "coef_xt", "std"):
            np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                       rtol=1e-6, atol=0)


def _jax_chain(jm, params, mask, key, steps: int, **kw):
    """JAX's continuous sampler over a respaced chain of ``steps``, with
    its states, and the prior and step noise it drew, as the port takes
    them."""
    res = jm.sample(jax.tree.map(jnp.asarray, params), jnp.asarray(mask), key, save_traj=True,
                    num_steps=steps, **kw)
    b, n = mask.shape
    e = n * (n - 1) // 2
    shapes = ((b, n, 3), (b, n, KN), (b, e, KE))
    k_node, k_pos, k_edge, key = jax.random.split(key, 4)
    draw = lambda k, s: torch.tensor(np.asarray(jax.random.normal(k, s, jnp.float32)))
    prior = StepNoise(draw(k_pos, shapes[0]), draw(k_node, shapes[1]), draw(k_edge, shapes[2]))
    noises = []
    for _ in range(steps):
        key, k_pos, k_node, k_edge = jax.random.split(key, 4)
        noises.append(StepNoise(draw(k_pos, shapes[0]), draw(k_node, shapes[1]),
                                draw(k_edge, shapes[2])))
    return res, prior, noises


def _step_against_jax(jm, tm, params, guided=None):
    mask = batch(0)["node_mask"]
    steps = 2
    kw, tkw = {}, {}
    if guided:
        (jbp, jbp_params), (tbp, tbp_params) = guided
        kw = {"guidance": ("uncertainty", 1e-1), "bond_predictor": (jbp, jbp_params)}
        tkw = {"guidance": ("uncertainty", 1e-1), "bond_predictor": (tbp, tbp_params)}
    res, prior, noises = _jax_chain(jm, params, mask, jax.random.key(2), steps, **kw)
    state = tm.init_state(torch.tensor(mask), prior)
    for x, w in zip((state.h_node, state.pos, state.h_halfedge), res.traj):
        np.testing.assert_allclose(x.numpy(), np.asarray(w[0]), **TOL)
    trs, t_map = tm._respaced(steps, 1.0)
    tp = params_to_torch(params, "cpu")
    for i, step in enumerate(range(steps - 1, -1, -1)):
        # commit and pos_sampler are not read in this space
        state = tm.reverse_step(tp, state, step, torch.tensor(mask), noises[i],
                                commit="both", pos_sampler="ddim", transitions=trs,
                                t_model=int(t_map[step]), **tkw)
        for x, w in zip((state.h_node, state.pos, state.h_halfedge), res.traj):
            np.testing.assert_allclose(x.numpy(), np.asarray(w[i + 1]), **TOL)
    for g, w in zip(state.preds, (res.pred_node, res.pred_pos, res.pred_halfedge)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    return res


def test_reverse_step_equals_jax(cont_model):
    """Each step of a 2-step respaced chain (step 1 draws noise, step 0
    returns the posterior mean) equals JAX's sampler state given JAX's
    noise: atom, position and bond features and the final predictions."""
    jm, tm, params = cont_model
    _step_against_jax(jm, tm, params)


def test_guided_reverse_step_equals_jax(cont_model):
    """The same with uncertainty guidance by a bond predictor (T = 1000):
    the position drift from the new bond features' argmax and log-softmax,
    at every step."""
    jm, tm, params = cont_model
    cfg = predictor_cfg()
    cfg["diff"]["num_timesteps"] = 1000
    jbp, tbp = predictor_pair(cfg)
    bp_params = np_tree(jbp.init_params(jax.random.key(4)))
    guided = ((jbp, jax.tree.map(jnp.asarray, bp_params)),
              (tbp, params_to_torch(bp_params, "cpu")))
    res = _step_against_jax(jm, tm, params, guided)
    plain, _, _ = _jax_chain(jm, params, batch(0)["node_mask"], jax.random.key(2), 2)
    assert float(np.abs(np.asarray(res.pred_pos) - np.asarray(plain.pred_pos)).max()) > 1e-4


def test_edge_guidance_raises(cont_model):
    """JAX silently ignores edge_guidance > 0 in this space; the port
    refuses it, in sample() and in reverse_step()."""
    _, tm, params = cont_model
    mask = torch.tensor(batch(0)["node_mask"])
    tp = params_to_torch(params, "cpu")
    bp = (object(), None)
    with pytest.raises(ValueError, match="edge_guidance"):
        tm.sample(tp, mask, torch.Generator().manual_seed(0), bond_predictor=bp,
                  edge_guidance=1.0, num_steps=2)
    state = tm.init_state(mask, tm.draw_noise(B, N, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="edge_guidance"):
        tm.reverse_step(tp, state, 3, mask, tm.draw_noise(B, N, torch.Generator()),
                        bond_predictor=bp, edge_guidance=1.0)


def test_traced_chain_decodes(cont_model):
    """sample() with save_traj: S + 1 states of class indices (their
    argmax) and positions; commit and the position sampler change nothing;
    the final predictions decode into elements and positions."""
    from moldiff_tpu_torch.data.featurize import featurizer_from_config
    from moldiff_tpu_torch.utils.config import Config, load_config

    _, tm, params = cont_model
    tp = params_to_torch(params, "cpu")
    mask = torch.tensor(batch(0)["node_mask"])
    preds, traj = tm.sample(tp, mask, torch.Generator().manual_seed(5), num_steps=4,
                            save_traj=True)
    other = tm.sample(tp, mask, torch.Generator().manual_seed(5), num_steps=4, commit="both",
                      pos_sampler="ddim", eta=1.0)
    for a, b in zip(preds, other):
        assert torch.equal(a, b)
    assert traj.node.shape == (5, B, N) and traj.halfedge.shape == (5, B, N * (N - 1) // 2)
    assert traj.node.dtype == torch.uint8 and int(traj.node.max()) < KN
    feat = featurizer_from_config(Config(load_config("configs/train/train_v2_cont.yml")))
    n0 = int(mask[0].sum())
    dec = feat.decode_output(preds.pred_node[0, :n0].numpy(), preds.pred_pos[0, :n0].numpy(),
                             preds.pred_halfedge[0, :n0 * (n0 - 1) // 2].numpy())
    assert len(dec["element"]) <= n0 and np.isfinite(dec["atom_pos"]).all()


def test_sample_cli_on_a_continuous_checkpoint(tmp_path):
    """The sample CLI's run() on a continuous checkpoint (the demo weights
    under a continuous config) runs a respaced chain and writes its
    summary; with edge_guidance it raises before any chain."""
    blob = load_checkpoint_numpy("ckpts/demo_synthetic_30k.ckpt")
    blob["config"] = blob["config"].to_dict()
    blob["config"]["model"]["diff"].update(CONTINUOUS)
    path = tmp_path / "continuous.ckpt"
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    sample = {"seed": 1, "batch_size": 4, "num_mols": 1, "num_steps": 3, "commit": "nodes",
              "buckets": [32]}
    summary = cli.run({"model": {"checkpoint": str(path)}, "sample": sample}, device="cpu",
                      outdir=str(tmp_path), log=lambda m: None)
    assert summary["chains"] >= 1 and summary["num_steps"] == 3
    guided = {"model": {"checkpoint": str(path)}, "bond_predictor": "ckpts/demo_bondpred_4k.ckpt",
              "sample": dict(sample, edge_guidance=1.0)}
    with pytest.raises(ValueError, match="edge_guidance"):
        cli.run(guided, device="cpu", outdir=str(tmp_path), log=lambda m: None)
