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


@pytest.mark.parametrize("commit", ["none", "nodes"])
def test_reverse_step_given_same_noise(demo, commit):
    """One reverse step (float32, the committed demo checkpoint, B = 2,
    N = 16) equals the JAX scan body given the noise JAX draws from the
    step's key: positions to 1e-4, the sampled atom and bond classes, the
    commit state and the carried log-posteriors. The JAX body reads the
    denoiser predictions that MolDiff.forward gives for the step's inputs
    (forward parity is the flagship tests above), so the JAX side runs only
    the step's own arithmetic."""
    from moldiff_tpu.models.moldiff import MolDiffPreds as JPreds

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
    step = 60
    preds = tm.forward(ck_t["params"], torch.tensor(node), torch.tensor(pos),
                       torch.tensor(edge), torch.full((b,), step), torch.tensor(mask))
    jm.forward = lambda *a, **k: JPreds(*(jnp.asarray(p.numpy()) for p in preds))
    body = jm._make_scan_body(ck_j["params"], jnp.asarray(mask), None, None, False,
                              commit=commit)
    key = jax.random.key(11)
    carry = (jnp.asarray(pos), jnp.asarray(node), jnp.asarray(edge), jnp.asarray(log_node),
             jnp.asarray(log_edge),
             (jnp.asarray(com_node, jnp.int32), jnp.full((b, e), -1, jnp.int32)),
             jm.forward(), key)
    (pos_j, node_j, edge_j, lnode_j, ledge_j, (com_j, _), preds_j, _), _ = body(carry, step)

    _, k_pos, k_node, k_edge = jax.random.split(key, 4)
    noise = StepNoise(
        pos=torch.tensor(np.asarray(jax.random.normal(k_pos, (b, n, 3), jnp.float32))),
        node=torch.tensor(np.asarray(jax.random.uniform(k_node, (b, n, 8), jnp.float32))),
        edge=torch.tensor(np.asarray(jax.random.uniform(k_edge, (b, e, 6), jnp.float32))))
    state = SampleState(torch.tensor(pos), torch.tensor(node), torch.tensor(edge),
                        torch.tensor(log_node), torch.tensor(log_edge),
                        torch.tensor(com_node).long())
    out = tm.reverse_step(ck_t["params"], state, step, torch.tensor(mask), noise, commit=commit)
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(pos_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.h_node.numpy(), np.asarray(node_j))
    np.testing.assert_array_equal(out.h_halfedge.numpy(), np.asarray(edge_j))
    np.testing.assert_array_equal(out.com_node.numpy(), np.asarray(com_j))
    np.testing.assert_allclose(out.log_node.numpy(), np.asarray(lnode_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.log_halfedge.numpy(), np.asarray(ledge_j),
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(out.preds, preds_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    if commit == "nodes":
        assert (out.com_node.numpy() >= 0).sum() > (com_node >= 0).sum()  # a reveal happened
