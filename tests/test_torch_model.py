"""moldiff_tpu_torch's denoiser and MolDiff.forward against moldiff_tpu on
the committed flagship_v2 weights (B = 2, N = 32), and one reverse step on
the committed demo weights.

float32 is where the two must agree to summation order; bf16 is where the
port's kernel path (the JAX package's use_pallas + pallas_bwd roundings)
must stay within 2x the JAX XLA path's own bf16 error against float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models import denoiser as jden
from moldiff_tpu.models.moldiff import MolDiff as JMolDiff
from moldiff_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from moldiff_tpu_torch.models import denoiser as tden
from moldiff_tpu_torch.models.moldiff import MolDiff, SampleState, StepNoise
from moldiff_tpu_torch.utils.checkpoint import load_checkpoint
from torch_port_util import max_err, to_np

B, N = 2, 32
E = N * (N - 1) // 2


@pytest.fixture(scope="module")
def flagship():
    ck_j = jax_load_checkpoint("ckpts/flagship_v2.ckpt")
    ck_t = load_checkpoint("ckpts/flagship_v2.ckpt", device="cpu")
    return ck_j, ck_t


def _model_cfg(ck, dtype):
    cfg = dict(ck["config"]["model"])
    cfg["denoiser"] = dict(cfg["denoiser"], dtype=dtype, remat=False)
    return cfg


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    node_mask = np.zeros((B, N), np.float32)
    node_mask[0, :25] = 1
    node_mask[1, :] = 1
    return dict(
        node=np.eye(8, dtype=np.float32)[rng.integers(0, 8, (B, N))],
        edge=np.eye(6, dtype=np.float32)[rng.integers(0, 6, (B, E))],
        pos=(rng.normal(size=(B, N, 3)) * 2).astype(np.float32),
        t=np.array([500, 10], np.int32),
        mask=node_mask,
    )


def _forward_pair(flagship, inputs, dtype):
    ck_j, ck_t = flagship
    jm = JMolDiff(_model_cfg(ck_j, dtype), 8, 6)
    tm = MolDiff(_model_cfg(ck_t, dtype), 8, 6, device="cpu")
    i = inputs
    want = jm.forward(ck_j["params"], i["node"], i["pos"], i["edge"], i["t"], i["mask"])
    got = tm.forward(ck_t["params"], torch.tensor(i["node"]), torch.tensor(i["pos"]),
                     torch.tensor(i["edge"]), torch.tensor(i["t"]).long(),
                     torch.tensor(i["mask"]))
    return [to_np(w) for w in want], [to_np(g) for g in got]


@pytest.fixture(scope="module")
def forward_f32(flagship, inputs):
    return _forward_pair(flagship, inputs, "float32")


@pytest.mark.parametrize("k,name", [(0, "pred_node"), (1, "pred_pos"), (2, "pred_halfedge")])
def test_forward_f32(forward_f32, k, name):
    """float32: each output to 1e-5 of its range."""
    want, got = forward_f32
    assert got[k].shape == want[k].shape
    assert max_err(got[k], want[k]) <= 1e-5 * np.abs(want[k]).max()


@pytest.fixture(scope="module")
def forward_bf16(flagship, inputs):
    return _forward_pair(flagship, inputs, "bfloat16")


@pytest.mark.parametrize("k,name", [(0, "pred_node"), (1, "pred_pos"), (2, "pred_halfedge")])
def test_forward_bf16(forward_f32, forward_bf16, k, name):
    """bf16 compute: error against the float32 JAX forward within 2x that
    of the JAX bf16 forward."""
    ref = forward_f32[0][k]
    want, got = forward_bf16
    assert np.isfinite(got[k]).all()
    assert max_err(got[k], ref) <= 2 * max_err(want[k], ref)


@pytest.mark.parametrize("update_pos", [False])
def test_node_edge_net_f32(flagship, inputs, update_pos):
    """The denoiser alone with frozen positions (update_pos False, the bond
    predictor's setting; MolDiff.forward above covers True)."""
    ck_j, ck_t = flagship
    rng = np.random.default_rng(3)
    h_node = rng.normal(size=(B, N, 256)).astype(np.float32)
    h_edge = rng.normal(size=(B, N, N, 64)).astype(np.float32)
    tn = np.array([0.5, 0.01], np.float32).reshape(B, 1, 1)
    m = inputs["mask"]
    pair = m[:, :, None] * m[:, None, :] * (1 - np.eye(N, dtype=np.float32))
    dcfg = dict(ck_j["config"]["model"]["denoiser"], update_pos=update_pos, dtype="float32")
    dcfg.pop("backbone")
    js = jden.denoiser_static_config(**dcfg)
    want = jden.node_edge_net(ck_j["params"]["denoiser"], js, h_node, inputs["pos"], h_edge,
                              tn, tn, pair, remat=False)
    ts = tden.denoiser_static_config(**dcfg)
    got = tden.node_edge_net(ck_t["params"]["denoiser"], ts, torch.tensor(h_node),
                             torch.tensor(inputs["pos"]), torch.tensor(h_edge),
                             torch.tensor(tn), torch.tensor(tn), torch.tensor(pair))
    for w, g in zip(want, got):
        assert max_err(g, w) <= 1e-5 * max(np.abs(to_np(w)).max(), 1.0)
    if not update_pos:
        np.testing.assert_array_equal(got[1].numpy(), inputs["pos"])


@pytest.fixture(scope="module")
def demo():
    path = "ckpts/demo_synthetic_30k.ckpt"
    return jax_load_checkpoint(path), load_checkpoint(path, device="cpu")


def test_respaced_transitions_equal_jax(demo):
    """_respaced's transitions (Gaussian coefficients, categorical
    matrices and priors) are within 1e-6 relative of JAX _respaced's, and
    t_map is equal, for a uniform and a warped spacing."""
    ck_j, ck_t = demo
    jm = JMolDiff(_model_cfg(ck_j, "float32"), 8, 6)
    tm = MolDiff(_model_cfg(ck_t, "float32"), 8, 6, device="cpu")
    for steps, gamma in ((50, 1.0), (30, 2.0)):
        (jpos, jnode, jedge), jmap = jm._respaced(steps, gamma)
        (tpos, tnode, tedge), tmap = tm._respaced(steps, gamma)
        np.testing.assert_array_equal(tmap, np.asarray(jmap))
        for name in ("alphas_bar", "alphas_bar_prev", "coef_x0", "coef_xt", "std"):
            np.testing.assert_allclose(getattr(tpos, name).numpy(),
                                       np.asarray(getattr(jpos, name)), rtol=1e-6, atol=0)
        for jt, tt in ((jnode, tnode), (jedge, tedge)):
            for name in ("alphas_bar", "q_mats", "transpose_q_onestep_mats", "init_prob"):
                np.testing.assert_allclose(getattr(tt, name).numpy(),
                                           np.asarray(getattr(jt, name)), rtol=1e-6, atol=0)
        assert tm._respaced(steps, gamma)[0] is tm._respaced(steps, gamma)[0]   # cached


# (commit, pos_sampler, respaced steps or None); the first two keep the ids
# this test had before it took the other modes
STEP_CASES = [("none", "ddpm", None), ("nodes", "ddpm", None), ("edges", "ddpm", None),
              ("both", "ddpm", None), ("none", "ddim", None), ("nodes", "ddim", None),
              ("edges", "ddim", None), ("both", "ddim", None), ("both", "ddim", 50)]


def _step_id(case):
    commit, sampler, steps = case
    if steps:
        return f"{commit}-{sampler}-s{steps}"
    return commit if sampler == "ddpm" else f"{commit}-{sampler}"


@pytest.mark.parametrize("case", STEP_CASES, ids=[_step_id(c) for c in STEP_CASES])
def test_reverse_step_given_same_noise(demo, case):
    """One reverse step (float32, the committed demo checkpoint, B = 2,
    N = 16) equals the JAX scan body given the noise JAX draws from the
    step's key, for every commit mode, both position samplers (ddim with
    eta 0.5) and a respaced step (50 of 200): positions to 1e-5, the
    sampled atom and bond classes, the commit state of atoms and half-edges
    and the carried log-posteriors to 1e-4. The JAX body reads the denoiser
    predictions that MolDiff.forward gives for the step's inputs at the
    original timestep (forward parity is the flagship tests above), so the
    JAX side runs only the step's own arithmetic, and the port's own forward
    must read that timestep too."""
    from moldiff_tpu.models.moldiff import MolDiffPreds as JPreds

    commit, pos_sampler, num_steps = case
    eta = 0.5 if pos_sampler == "ddim" else 0.0
    ck_j, ck_t = demo
    jm = JMolDiff(_model_cfg(ck_j, "float32"), 8, 6)
    tm = MolDiff(_model_cfg(ck_t, "float32"), 8, 6, device="cpu")
    b, n = 2, 16
    e = n * (n - 1) // 2
    rng = np.random.default_rng(5)
    mask = (np.arange(n)[None] < np.array([[16], [11]])).astype(np.float32)
    node = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (b, n))]
    edge = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (b, e))]
    pos = (rng.normal(size=(b, n, 3)) * 2).astype(np.float32)
    log_node = np.log(np.clip(node, 1e-30, None))
    log_edge = np.log(np.clip(edge, 1e-30, None))
    com_node = np.where(rng.uniform(size=(b, n)) < 0.3, rng.integers(0, 7, (b, n)), -1)
    com_edge = np.where(rng.uniform(size=(b, e)) < 0.2, rng.integers(1, 6, (b, e)), -1)
    transitions = t_map = None
    step = t_model = 60
    if num_steps:
        transitions, t_map = jm._respaced(num_steps)
        step = 15
        t_model = int(t_map[step])
        assert t_model != step
    preds = tm.forward(ck_t["params"], torch.tensor(node), torch.tensor(pos),
                       torch.tensor(edge), torch.full((b,), t_model), torch.tensor(mask))
    jm.forward = lambda *a, **k: JPreds(*(jnp.asarray(p.numpy()) for p in preds))
    body = jm._make_scan_body(ck_j["params"], jnp.asarray(mask), None, None, False,
                              transitions=transitions, t_map=t_map, pos_sampler=pos_sampler,
                              eta=eta, commit=commit)
    key = jax.random.key(11)
    carry = (jnp.asarray(pos), jnp.asarray(node), jnp.asarray(edge), jnp.asarray(log_node),
             jnp.asarray(log_edge),
             (jnp.asarray(com_node, jnp.int32), jnp.asarray(com_edge, jnp.int32)),
             jm.forward(), key)
    (pos_j, node_j, edge_j, lnode_j, ledge_j, (com_j, come_j), preds_j, _), _ = body(carry, step)

    _, k_pos, k_node, k_edge = jax.random.split(key, 4)
    noise = StepNoise(
        pos=torch.tensor(np.asarray(jax.random.normal(k_pos, (b, n, 3), jnp.float32))),
        node=torch.tensor(np.asarray(jax.random.uniform(k_node, (b, n, 8), jnp.float32))),
        edge=torch.tensor(np.asarray(jax.random.uniform(k_edge, (b, e, 6), jnp.float32))))
    state = SampleState(torch.tensor(pos), torch.tensor(node), torch.tensor(edge),
                        torch.tensor(log_node), torch.tensor(log_edge),
                        torch.tensor(com_node).long(), torch.tensor(com_edge).long())
    out = tm.reverse_step(ck_t["params"], state, step, torch.tensor(mask), noise, commit=commit,
                          transitions=tm._respaced(num_steps)[0] if num_steps else None,
                          t_model=t_model if num_steps else None, pos_sampler=pos_sampler,
                          eta=eta)
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(pos_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.h_node.numpy(), np.asarray(node_j))
    np.testing.assert_array_equal(out.h_halfedge.numpy(), np.asarray(edge_j))
    np.testing.assert_array_equal(out.com_node.numpy(), np.asarray(com_j))
    np.testing.assert_array_equal(out.com_edge.numpy(), np.asarray(come_j))
    np.testing.assert_allclose(out.log_node.numpy(), np.asarray(lnode_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.log_halfedge.numpy(), np.asarray(ledge_j),
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(out.preds, preds_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    if commit in ("nodes", "both"):
        assert (out.com_node.numpy() >= 0).sum() > (com_node >= 0).sum()  # a reveal happened
    if commit in ("edges", "both"):
        assert (out.com_edge.numpy() >= 0).sum() > (com_edge >= 0).sum()


# ---------------------------------------------------------------------------
# the two route knobs: fuse_block (row 2) and edge_full (rows 6, 7)
# ---------------------------------------------------------------------------

SB, SN, SDN, SDE, SBLOCKS = 3, 8, 64, 32, 2


@pytest.fixture(scope="module")
def small_net():
    """A narrow 2-block gated denoiser (random weights) and padded inputs
    (8, 6 and 2 atoms)."""
    from torch_port_util import np_tree

    params, _ = jden.init_node_edge_net(jax.random.key(5), SDN, SDE, num_blocks=SBLOCKS,
                                        cutoff=10.0, use_gate=True)
    rng = np.random.default_rng(9)
    node_mask = (np.arange(SN)[None] < np.array([8, 6, 2])[:, None]).astype(np.float32)
    pair = (node_mask[:, :, None] * node_mask[:, None, :]
            * (1 - np.eye(SN, dtype=np.float32))).astype(np.float32)
    inputs = (rng.normal(size=(SB, SN, SDN)).astype(np.float32),
              (rng.normal(size=(SB, SN, 3)) * 2 * node_mask[..., None]).astype(np.float32),
              rng.normal(size=(SB, SN, SN, SDE)).astype(np.float32),
              rng.uniform(size=(SB, 1, 1)).astype(np.float32), pair)
    return np_tree(params), inputs


def _small_static(lib, dtype, **flags):
    return lib.denoiser_static_config(num_blocks=SBLOCKS, cutoff=10.0, use_gate=True,
                                      dtype=dtype, remat=False, use_pallas=True,
                                      pallas_bwd=True, **flags)


def _jax_net(small_net, dtype, **flags):
    """JAX's node_edge_net with the flags on its kernel path, every Pallas
    kernel interpreted."""
    from moldiff_tpu.ops import pallas_kernels

    params, (h_node, pos, h_edge, tn, pair) = small_net
    static = _small_static(jden, dtype, **flags)
    saved = pallas_kernels.INTERPRET
    pallas_kernels.INTERPRET = True
    try:
        out = jax.jit(lambda p, *a: jden.node_edge_net(p, static, *a, remat=False))(
            params, h_node, pos, h_edge, tn, tn, pair)
    finally:
        pallas_kernels.INTERPRET = saved
    return [to_np(o) for o in out]


def _torch_net(small_net, dtype, **flags):
    from torch_port_util import torch_tree

    params, (h_node, pos, h_edge, tn, pair) = small_net
    with torch.no_grad():
        out = tden.node_edge_net(torch_tree(params), _small_static(tden, dtype, **flags),
                                 *map(torch.tensor, (h_node, pos, h_edge, tn, tn, pair)))
    return [to_np(o) for o in out]


ROUTES = [{"fuse_block": True}, {"edge_full": True}]


@pytest.fixture(scope="module")
def jax_routes(small_net):
    return {(k, dt): _jax_net(small_net, dt, **{k: True})
            for k in ("fuse_block", "edge_full") for dt in ("float32", "bfloat16")}


@pytest.mark.parametrize("flags", ROUTES, ids=lambda f: next(iter(f)))
def test_node_edge_net_route_f32(small_net, jax_routes, flags):
    """float32: node_edge_net with fuse_block (row 2) or edge_full (rows 6,
    7) equals JAX's node_edge_net with the same flags on its Pallas path,
    each output to 1e-4 of its range (the kernels' own tolerance)."""
    want = jax_routes[(next(iter(flags)), "float32")]
    got = _torch_net(small_net, "float32", **flags)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert max_err(g, w) <= 1e-4 * max(np.abs(w).max(), 1.0)


@pytest.mark.parametrize("flags", ROUTES, ids=lambda f: next(iter(f)))
def test_node_edge_net_route_bf16(small_net, jax_routes, flags):
    """bf16 compute: error against JAX's float32 result with the same flags
    within 2x that of JAX's bf16 result with them (the bf16 rule above)."""
    name = next(iter(flags))
    ref, want = jax_routes[(name, "float32")], jax_routes[(name, "bfloat16")]
    got = _torch_net(small_net, "bfloat16", **flags)
    for r, w, g in zip(ref, want, got):
        assert np.isfinite(g).all()
        assert max_err(g, r) <= 2 * max_err(w, r)


def _count_calls(monkeypatch):
    """Count the plain versions each route reaches (the wrappers take them
    for CPU tensors)."""
    from moldiff_tpu_torch.ops import kernels

    calls = {}
    for name in ("fused_block_plain", "edge_block_full_plain", "edge_pair_aggregate_plain",
                 "node_block_aggregate_plain", "pos_update_plain"):
        def counted(*a, _f=getattr(kernels, name), _n=name):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a)
        monkeypatch.setattr(kernels, name, counted)
    return calls


def test_fuse_block_takes_precedence_over_edge_full(small_net, monkeypatch):
    """With both flags a block that updates edges and positions is the
    whole-block kernel (denoiser.py:521-535 returns before the EdgeBlock):
    the result is fuse_block's alone."""
    calls = _count_calls(monkeypatch)
    both = _torch_net(small_net, "float32", fuse_block=True, edge_full=True)
    assert calls == {"fused_block_plain": SBLOCKS}
    calls.clear()
    fused = _torch_net(small_net, "float32", fuse_block=True)
    for a, b in zip(both, fused):
        np.testing.assert_array_equal(a, b)
    calls.clear()
    _torch_net(small_net, "float32", edge_full=True)
    assert calls == {"node_block_aggregate_plain": SBLOCKS, "edge_block_full_plain": SBLOCKS,
                     "pos_update_plain": SBLOCKS}


def test_bond_predictor_never_takes_row_2(small_net, monkeypatch):
    """The bond predictor's setting (update_pos false) never takes the
    whole-block kernel; its edge_full takes rows 6 and 7, as
    denoiser.py:521-526 and :235-244 read the flags."""
    from torch_port_util import torch_tree

    from moldiff_tpu_torch.models.bond_predictor import BondPredictor

    params, (h_node, pos, h_edge, tn, pair) = small_net
    calls = _count_calls(monkeypatch)
    static = dict(_small_static(tden, "float32", fuse_block=True, edge_full=True),
                  update_pos=False)
    with torch.no_grad():
        out = tden.node_edge_net(torch_tree(params), static,
                                 *map(torch.tensor, (h_node, pos, h_edge, tn, tn, pair)))
    assert calls == {"node_block_aggregate_plain": SBLOCKS, "edge_block_full_plain": SBLOCKS}
    np.testing.assert_array_equal(out[1].numpy(), pos)
    ck = load_checkpoint("ckpts/bondpred_v2.ckpt", device="cpu")
    cfg = dict(ck["config"]["model"])
    cfg["encoder"] = dict(cfg["encoder"], fuse_block=True)
    bp = BondPredictor(cfg, 8, 6, device="cpu")
    assert bp.encoder_static["fuse_block"] and not bp.encoder_static["update_pos"]
