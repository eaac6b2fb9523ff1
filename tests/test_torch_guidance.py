"""Bond guidance in moldiff_tpu_torch against moldiff_tpu (tests/
test_guidance.py's cases as comparisons): the position delta in all eight
modes, its padding, guidance_interval, zero scale, one guided reverse step
and one edge-guidance step, given the same inputs and noise. The JAX bond
predictor runs its kernel path (use_pallas + pallas_bwd) with the Pallas
kernels in interpret mode, so its gradient goes through the Pallas backward
kernels that the port's plain backward versions mirror."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models.bond_predictor import BondPredictor as JBondPredictor
from moldiff_tpu.models.moldiff import MolDiff as JMolDiff
from moldiff_tpu.models.moldiff import MolDiffPreds as JPreds
from moldiff_tpu.models.moldiff import _bond_guidance_delta
from moldiff_tpu.ops import pallas_kernels
from moldiff_tpu.utils.config import Config
from moldiff_tpu_torch.models.bond_predictor import BondPredictor
from moldiff_tpu_torch.models.moldiff import (
    MolDiff, SampleState, StepNoise, bond_guidance_delta)
from torch_port_util import np_tree, torch_tree

MODES = ["entropy", "uncertainty", "uncertainty_bond", "entropy_bond",
         "logit_bond", "logit", "crossent", "crossent_bond"]
KN, KE, KBP = 8, 6, 5
B, N = 2, 7
E = N * (N - 1) // 2
SCHED = {"beta_schedule": "advance", "scale_start": 0.9999, "scale_end": 0.0001, "width": 3}
DIFF = {"num_timesteps": 6, "time_dim": 4, "categorical_space": "discrete",
        "diff_pos": dict(SCHED), "diff_atom": dict(SCHED, init_prob="tomask"),
        "diff_bond": dict(SCHED, init_prob="absorb")}
BP_CFG = {"node_dim": 32, "edge_dim": 16,
          "encoder": {"num_blocks": 1, "cutoff": 10, "use_gate": True, "update_edge": True,
                      "update_pos": False, "use_pallas": True, "pallas_bwd": True,
                      "remat": False},
          "diff": {k: DIFF[k] for k in ("num_timesteps", "time_dim", "categorical_space",
                                        "diff_pos", "diff_atom")}}
MD_CFG = {"node_dim": 32, "edge_dim": 16,
          "denoiser": {"num_blocks": 1, "cutoff": 10, "use_gate": True, "remat": False},
          "diff": DIFF}


@pytest.fixture(scope="module")
def models():
    jbp = JBondPredictor(Config(BP_CFG), KN, KBP)
    jbp_params = jbp.init_params(jax.random.key(1))
    bp = BondPredictor(BP_CFG, KN, KBP, device="cpu")
    jmd = JMolDiff(Config(MD_CFG), KN, KE)
    jmd_params = jmd.init_params(jax.random.key(0))
    md = MolDiff(MD_CFG, KN, KE, device="cpu")
    return (jbp, jbp_params, bp, torch_tree(np_tree(jbp_params)),
            jmd, jmd_params, md, torch_tree(np_tree(jmd_params)))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(4)
    node_mask = np.ones((B, N), np.float32)
    node_mask[1, 5:] = 0.0
    return dict(
        node=np.eye(KN, dtype=np.float32)[rng.integers(0, KN, (B, N))],
        pos=rng.normal(size=(B, N, 3)).astype(np.float32) * 1.5,
        edge=np.eye(KE, dtype=np.float32)[rng.integers(0, KE, (B, E))],
        t=np.full((B,), 3, np.int32),
        mask=node_mask,
        he_prev=rng.integers(0, KE, (B, E)).astype(np.int32),
        log_he=np.log(rng.dirichlet(np.ones(KE), (B, E))).astype(np.float32),
    )


@pytest.fixture(scope="module")
def interpret():
    saved = pallas_kernels.INTERPRET
    pallas_kernels.INTERPRET = True
    yield
    pallas_kernels.INTERPRET = saved


class _CachedPredictor:
    """The JAX predictor's forward at the test's inputs, run once: forward()
    returns its logits and differentiates through its recorded VJP, so each
    mode runs _bond_guidance_delta's own score, sign and scale without
    running the interpreted Pallas forward again."""

    def __init__(self, jbp, jbp_params, i):
        fwd = lambda p: jbp.forward(jbp_params, jnp.asarray(i["node"]), p, jnp.asarray(i["t"]),
                                    jnp.asarray(i["mask"]))
        self.pos = jnp.asarray(i["pos"])
        self.pred, self.vjp = jax.vjp(fwd, self.pos)

    def forward(self, params, h_node, pos, t, node_mask):
        @jax.custom_vjp
        def f(p):
            return self.pred

        f.defvjp(lambda p: (self.pred, None), lambda _, ct: self.vjp(ct))
        return f(pos)


@pytest.fixture(scope="module")
def cached(models, inputs, interpret):
    return _CachedPredictor(models[0], models[1], inputs)


def _deltas(models, inputs, cached, mode, scale=1.0):
    bp, bp_params = models[2:4]
    i = inputs
    want = _bond_guidance_delta(
        (cached, None), mode, scale, h_node_pert=jnp.asarray(i["node"]),
        pos_pert=jnp.asarray(i["pos"]), t=jnp.asarray(i["t"]), node_mask=jnp.asarray(i["mask"]),
        halfedge_type_prev=jnp.asarray(i["he_prev"]), log_halfedge_type=jnp.asarray(i["log_he"]))
    with torch.no_grad():   # as in sampling: the delta turns autograd on itself
        got = bond_guidance_delta(
            (bp, bp_params), mode, scale, torch.tensor(i["node"]), torch.tensor(i["pos"]),
            torch.tensor(i["t"]).long(), torch.tensor(i["mask"]),
            torch.tensor(i["he_prev"]).long(), torch.tensor(i["log_he"]))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("mode", MODES)
def test_delta_equals_jax_in_every_mode(models, inputs, cached, mode):
    """float32: the port's delta equals JAX's to 1e-4 of its largest
    component, is finite, and is zero on padded atoms (as JAX's is)."""
    want, got = _deltas(models, inputs, cached, mode)
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert np.all(got[inputs["mask"] == 0] == 0.0)


def test_delta_ignores_padded_atoms(models, inputs):
    """Moving padded atoms or changing their types leaves the delta of the
    real atoms unchanged."""
    _, _, bp, bp_params = models[:4]
    i = dict(inputs)

    def delta(node, pos):
        with torch.no_grad():
            return bond_guidance_delta(
                (bp, bp_params), "uncertainty", 1.0, torch.tensor(node), torch.tensor(pos),
                torch.tensor(i["t"]).long(), torch.tensor(i["mask"]),
                torch.tensor(i["he_prev"]).long(), torch.tensor(i["log_he"])).numpy()

    pos2, node2 = i["pos"].copy(), i["node"].copy()
    pos2[1, 5:] += 7.0
    node2[1, 5:] = np.eye(KN, dtype=np.float32)[0]
    np.testing.assert_allclose(delta(node2, pos2)[1, :5], delta(i["node"], i["pos"])[1, :5],
                               rtol=1e-5, atol=1e-6)


def _state(inputs):
    i = inputs
    node, edge = i["node"], i["edge"]
    return SampleState(torch.tensor(i["pos"]), torch.tensor(node), torch.tensor(edge),
                       torch.tensor(np.log(np.clip(node, 1e-30, None))),
                       torch.tensor(np.log(np.clip(edge, 1e-30, None))),
                       torch.full((B, N), -1, dtype=torch.long))


def _noise(seed):
    rng = np.random.default_rng(seed)
    return StepNoise(pos=torch.tensor(rng.normal(size=(B, N, 3)).astype(np.float32)),
                     node=torch.tensor(rng.uniform(size=(B, N, KN)).astype(np.float32)),
                     edge=torch.tensor(rng.uniform(size=(B, E, KE)).astype(np.float32)))


def _port_step(models, inputs, step, **kw):
    _, _, bp, bp_params, _, _, md, md_params = models
    with torch.no_grad():
        return md.reverse_step(md_params, _state(inputs), step, torch.tensor(inputs["mask"]),
                               _noise(step), commit="nodes", bond_predictor=(bp, bp_params, None),
                               **kw)


def test_zero_scale_equals_unguided(models, inputs):
    got = _port_step(models, inputs, 3, guidance=("uncertainty", 0.0))
    want = _port_step(models, inputs, 3)
    for a, b in zip(got[:6], want[:6]):
        assert torch.equal(a, b)


def test_guidance_interval(models, inputs):
    """Guidance applies only where step % interval == 0 (step 0 included),
    as in the JAX scan body."""
    base = {s: _port_step(models, inputs, s).pos for s in (4, 3, 0)}
    every = {s: _port_step(models, inputs, s, guidance=("uncertainty", 1.0)).pos
             for s in (4, 3, 0)}
    third = {s: _port_step(models, inputs, s, guidance=("uncertainty", 1.0),
                           guidance_interval=3).pos for s in (4, 3, 0)}
    assert torch.equal(third[4], base[4])
    for s in (3, 0):
        assert torch.equal(third[s], every[s]) and not torch.equal(every[s], base[s])


def _jax_step(models, inputs, step, preds, noise, **kw):
    """The JAX scan body for one step, reading the port's denoiser
    predictions and the same noise."""
    jbp, jbp_params, _, _, jmd, jmd_params, _, _ = models
    i = inputs
    jmd.forward = lambda *a, **k: JPreds(*(jnp.asarray(p.numpy()) for p in preds))
    body = jmd._make_scan_body(jmd_params, jnp.asarray(i["mask"]), kw.get("guidance"),
                               (jbp, jbp_params), False, commit="nodes",
                               edge_guidance=kw.get("edge_guidance", 0.0),
                               edge_guidance_tmax=kw.get("edge_guidance_tmax"),
                               transitions=kw.get("transitions"), t_map=kw.get("t_map"))
    node, edge = i["node"], i["edge"]
    carry = (jnp.asarray(i["pos"]), jnp.asarray(node), jnp.asarray(edge),
             jnp.log(jnp.clip(jnp.asarray(node), 1e-30)),
             jnp.log(jnp.clip(jnp.asarray(edge), 1e-30)),
             (jnp.full((B, N), -1, jnp.int32), jnp.full((B, E), -1, jnp.int32)),
             jmd.forward(), jax.random.key(0))
    # the body splits its key into (pos, node, edge) draws; hand it ours
    saved = jax.random.split, jax.random.normal, jax.random.uniform
    draws = {"normal": jnp.asarray(noise.pos.numpy()),
             "uniform": [jnp.asarray(noise.node.numpy()), jnp.asarray(noise.edge.numpy())]}
    jax.random.normal = lambda key, shape, dtype=jnp.float32: draws["normal"]
    jax.random.uniform = lambda key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0: \
        draws["uniform"].pop(0)
    try:
        out, _ = body(carry, step)
    finally:
        jax.random.split, jax.random.normal, jax.random.uniform = saved
    return out


@pytest.mark.parametrize("kw", [{"guidance": ("uncertainty", 1.0)}, {"edge_guidance": 2.0}],
                         ids=["guidance", "edge_guidance"])
def test_step_equals_jax_given_same_noise(models, inputs, interpret, kw):
    """One guided (or edge-guided) reverse step, float32, equals the JAX
    scan body given the same denoiser predictions and noise: positions to
    1e-4, the sampled classes exactly, the carried log-posteriors to 1e-4."""
    _, _, _, _, _, _, md, md_params = models
    step = 3
    noise = _noise(step)
    with torch.no_grad():
        preds = md.forward(md_params, torch.tensor(inputs["node"]), torch.tensor(inputs["pos"]),
                           torch.tensor(inputs["edge"]), torch.full((B,), step),
                           torch.tensor(inputs["mask"]))
    got = _port_step(models, inputs, step, **kw)
    pos_j, node_j, edge_j, lnode_j, ledge_j, _, preds_j, _ = _jax_step(
        models, inputs, step, preds, noise, **kw)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(pos_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.h_node.numpy(), np.asarray(node_j))
    np.testing.assert_array_equal(got.h_halfedge.numpy(), np.asarray(edge_j))
    np.testing.assert_allclose(got.log_node.numpy(), np.asarray(lnode_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.log_halfedge.numpy(), np.asarray(ledge_j),
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(got.preds, preds_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tmax", [300, 0, 2])
def test_edge_guidance_tmax_step_equals_jax(models, inputs, interpret, tmax):
    """edge_guidance_tmax as the samplers read it: JAX's MolSampler turns a
    falsy tmax into None (every step), and so does the port's; one
    edge-guided reverse step at step 3 with each sampler's value equals the
    JAX scan body given the same noise (tmax 300 and 0 guide the step,
    tmax 2 leaves it unguided)."""
    from moldiff_tpu.sample.pipeline import MolSampler as JSampler
    from moldiff_tpu_torch.sample.pipeline import MolSampler

    jbp, jbp_params, bp, bp_params, jmd, _, md, md_params = models
    j_tmax = JSampler(jmd, None, bond_predictor=(jbp, jbp_params), edge_guidance=2.0,
                      edge_guidance_tmax=tmax).edge_guidance_tmax
    sampler = MolSampler(md, None, bond_predictor=(bp, bp_params), edge_guidance=2.0,
                         edge_guidance_tmax=tmax)
    assert sampler.edge_guidance_tmax == j_tmax == (tmax or None)
    step = 3
    noise = _noise(step)
    with torch.no_grad():
        preds = md.forward(md_params, torch.tensor(inputs["node"]), torch.tensor(inputs["pos"]),
                           torch.tensor(inputs["edge"]), torch.full((B,), step),
                           torch.tensor(inputs["mask"]))
    got = _port_step(models, inputs, step, edge_guidance=2.0,
                     edge_guidance_tmax=sampler.edge_guidance_tmax)
    unguided = _port_step(models, inputs, step)
    _, _, edge_j, _, ledge_j, _, _, _ = _jax_step(models, inputs, step, preds, noise,
                                                  edge_guidance=2.0, edge_guidance_tmax=j_tmax)
    np.testing.assert_array_equal(got.h_halfedge.numpy(), np.asarray(edge_j))
    np.testing.assert_allclose(got.log_halfedge.numpy(), np.asarray(ledge_j),
                               rtol=1e-4, atol=1e-4)
    # unguided, the step re-normalises the same log-probs (float rounding)
    moved = float((got.log_halfedge - unguided.log_halfedge).abs().max())
    assert (moved > 1e-3) if tmax != 2 else (moved < 1e-5), moved


@pytest.mark.parametrize("tmax", [2, 3], ids=["tmax_gates_off", "tmax_gates_on"])
def test_respaced_guided_step_reads_t_model(models, inputs, interpret, tmax):
    """A guided, edge-guided respaced step (3 of 6 steps: chain index 1 is
    original timestep 2) equals the JAX scan body given the same noise, so
    the predictor's forward under edge guidance, the edge_guidance_tmax gate
    and the position guidance all read the original timestep: at tmax 2 the
    gate is off for timestep 2 (on for the chain index), at tmax 3 on for
    both. The same step fed the chain index departs from JAX."""
    jmd, md, md_params = models[4], models[6], models[7]
    transitions, t_map = jmd._respaced(3)
    step, t_model = 1, int(t_map[1])
    assert t_model == 2
    noise = _noise(step)
    with torch.no_grad():
        preds = md.forward(md_params, torch.tensor(inputs["node"]), torch.tensor(inputs["pos"]),
                           torch.tensor(inputs["edge"]), torch.full((B,), t_model),
                           torch.tensor(inputs["mask"]))
    kw = {"guidance": ("uncertainty", 1.0), "edge_guidance": 2.0, "edge_guidance_tmax": tmax}
    port_tr = md._respaced(3)[0]
    got = _port_step(models, inputs, step, transitions=port_tr, t_model=t_model, **kw)
    pos_j, node_j, edge_j, lnode_j, ledge_j, _, preds_j, _ = _jax_step(
        models, inputs, step, preds, noise, transitions=transitions, t_map=t_map, **kw)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(pos_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.h_node.numpy(), np.asarray(node_j))
    np.testing.assert_array_equal(got.h_halfedge.numpy(), np.asarray(edge_j))
    np.testing.assert_allclose(got.log_node.numpy(), np.asarray(lnode_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.log_halfedge.numpy(), np.asarray(ledge_j),
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(got.preds, preds_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    wrong = _port_step(models, inputs, step, transitions=port_tr, **kw)
    assert float((wrong.pos - got.pos).abs().max()) > 1e-3
    assert float((wrong.log_halfedge - got.log_halfedge).abs().max()) > 1e-3
