"""moldiff_tpu_torch's schedules, graph ops, NN primitives and diffusion
transitions against moldiff_tpu's, on the same numpy inputs (and the same
random numbers, which the port takes as arguments)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models import nn as jnn
from moldiff_tpu.ops import categorical as jcat
from moldiff_tpu.ops import gaussian as jgauss
from moldiff_tpu.ops import graph_ops as jgo
from moldiff_tpu.ops import respace as jrespace
from moldiff_tpu.ops import schedules as jsched
from moldiff_tpu_torch.models import nn as tnn
from moldiff_tpu_torch.ops import categorical as tcat
from moldiff_tpu_torch.ops import gaussian as tgauss
from moldiff_tpu_torch.ops import graph_ops as tgo
from moldiff_tpu_torch.ops import respace as trespace
from moldiff_tpu_torch.ops import schedules as tsched

T = 1000
SEGMENT = dict(beta_schedule="segment", time_segment=[600, 400], segment_diff=[
    {"scale_start": 0.9999, "scale_end": 0.001, "width": 3},
    {"scale_start": 0.001, "scale_end": 0.0001, "width": 2}])
ADVANCE = dict(beta_schedule="advance", scale_start=0.9999, scale_end=0.0001, width=3)
SCHEDULES = {
    "segment": SEGMENT, "advance": ADVANCE,
    "quad": dict(beta_schedule="quad", beta_start=1e-4, beta_end=2e-2),
    "linear": dict(beta_schedule="linear", beta_start=1e-4, beta_end=2e-2),
    "const": dict(beta_schedule="const", beta_end=2e-2),
    "jsd": dict(beta_schedule="jsd"),
    "sigmoid": dict(beta_schedule="sigmoid", beta_start=1e-4, beta_end=2e-2),
    "cosine": dict(beta_schedule="cosine"),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_equal(name):
    """The copied schedules give bit-identical float64 betas."""
    a = jsched.get_beta_schedule(num_timesteps=T, **SCHEDULES[name])
    b = tsched.get_beta_schedule(num_timesteps=T, **SCHEDULES[name])
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [3, 8, 32])
def test_halfedge_dense_round_trip(n):
    rng = np.random.default_rng(n)
    h = rng.normal(size=(2, n * (n - 1) // 2, 5)).astype(np.float32)
    dense_j = np.asarray(jgo.halfedge_to_dense(jnp.asarray(h), n))
    dense_t = tgo.halfedge_to_dense(torch.tensor(h), n)
    np.testing.assert_array_equal(dense_j, dense_t.numpy())
    np.testing.assert_array_equal(tgo.dense_to_halfedge(dense_t).numpy(), h)
    np.testing.assert_array_equal(np.asarray(jgo.symmetrize_dense(jnp.asarray(dense_j))),
                                  tgo.symmetrize_dense(dense_t).numpy())
    mask = (np.arange(n)[None] < np.array([n, n - 1])[:, None]).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jgo.pair_mask_from_node_mask(jnp.asarray(mask))),
                                  tgo.pair_mask_from_node_mask(torch.tensor(mask)).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_layernorm_mlp(dtype):
    """linear / linear_parts / layernorm / mlp in float32 and bf16 (float32
    LayerNorm statistics): float32 to 1e-5, bf16 to two bf16 steps."""
    rng = np.random.default_rng(0)
    p = jax.tree.map(np.asarray, jnn.init_mlp(jax.random.key(0), 24, 8, 16))
    x = rng.normal(size=(5, 24)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p)
    tp = jax.tree.map(lambda a: torch.tensor(a).to(tdt), p)
    a = np.asarray(jnn.mlp(jp, jnp.asarray(x, jdt)), np.float32)
    b = tnn.mlp(tp, torch.tensor(x).to(tdt)).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2 ** -6 * np.abs(a).max()
    np.testing.assert_allclose(a, b, atol=tol, rtol=0)
    lin = jp["layers"][0]["lin"]
    parts_j = jnn.linear_parts(lin, (jnp.asarray(x[:, :10], jdt), jnp.asarray(x[:, 10:], jdt)),
                               (10, 14))
    parts_t = tnn.linear_parts(tp["layers"][0]["lin"],
                               (torch.tensor(x[:, :10]).to(tdt), torch.tensor(x[:, 10:]).to(tdt)),
                               (10, 14))
    np.testing.assert_allclose(np.asarray(parts_j, np.float32), parts_t.float().numpy(),
                               atol=1e-5 if dtype == "float32" else 0.05)


@pytest.mark.parametrize("kind", ["exp", "linear"])
def test_gaussian_smearing_and_safe_distance(kind):
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(2, 6, 3)).astype(np.float32) * 3
    rel = pos[:, :, None] - pos[:, None]
    dj = np.asarray(jnn.safe_distance(jnp.asarray(rel)))
    dt_ = tnn.safe_distance(torch.tensor(rel))
    np.testing.assert_allclose(dj, dt_.numpy(), rtol=1e-6)
    assert np.all(dt_.numpy()[:, range(6), range(6)] == 0)
    sj = jnn.GaussianSmearing(0.0, 15.0, 16, kind)
    st = tnn.GaussianSmearing(0.0, 15.0, 16, kind)
    np.testing.assert_allclose(np.asarray(sj(jnp.asarray(dj))), st(dt_).numpy(),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("t", [0, 1, 250, 999])
def test_gaussian_posterior_step(t):
    """get_prev_from_recon given the JAX draw of the same key."""
    betas = jsched.get_beta_schedule(num_timesteps=T, **ADVANCE)
    jt, tt = jgauss.GaussianTransition(betas), tgauss.GaussianTransition(betas)
    rng = np.random.default_rng(t)
    x_t = rng.normal(size=(3, 5, 3)).astype(np.float32)
    x0 = rng.normal(size=(3, 5, 3)).astype(np.float32)
    tv = np.full((3,), t, np.int32)
    key = jax.random.key(t)
    want = np.asarray(jt.get_prev_from_recon(jnp.asarray(x_t), jnp.asarray(x0),
                                             jnp.asarray(tv), key))
    noise = np.asarray(jax.random.normal(key, x_t.shape, jnp.float32))
    got = tt.get_prev_from_recon(torch.tensor(x_t), torch.tensor(x0),
                                 torch.tensor(tv).long(), torch.tensor(noise))
    np.testing.assert_allclose(want, got.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("prior,schedule,k", [("tomask", ADVANCE, 8), ("absorb", SEGMENT, 6)])
@pytest.mark.parametrize("t", [0, 1, 300, 599, 600, 999])
def test_q_v_posterior(prior, schedule, k, t):
    """log q(v_{t-1} | v_t, v0) for the atom (tomask) and bond (absorb,
    segment schedule) transitions: float32 log-probabilities to 1e-4."""
    betas = jsched.get_beta_schedule(num_timesteps=T, **schedule)
    jt = jcat.CategoricalTransition(betas, k, init_prob=prior)
    tt = tcat.CategoricalTransition(betas, k, init_prob=prior)
    np.testing.assert_allclose(np.asarray(jt.alphas_bar), tt.alphas_bar.numpy(), rtol=1e-6)
    rng = np.random.default_rng(t + k)
    logits = rng.normal(size=(2, 7, k)).astype(np.float32) * 3
    log_v0 = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    vt = rng.integers(0, k, size=(2, 7))
    log_vt = np.asarray(jcat.index_to_log_onehot(jnp.asarray(vt), k))
    tv = np.array([t, max(t - 1, 0)], np.int32)
    want = np.asarray(jt.q_v_posterior(jnp.asarray(log_v0), jnp.asarray(log_vt),
                                       jnp.asarray(tv), v0_prob=True))
    got = tt.q_v_posterior(torch.tensor(log_v0), torch.tensor(log_vt), torch.tensor(tv).long())
    np.testing.assert_allclose(want, got.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prior,k", [("tomask", 8), ("absorb", 6), ("uniform", 5)])
def test_categorical_draws_given_uniforms(prior, k):
    """sample_init and log_sample_categorical pick the same classes as JAX
    given the uniforms JAX drew from the same key."""
    betas = jsched.get_beta_schedule(num_timesteps=20, **ADVANCE)
    jt = jcat.CategoricalTransition(betas, k, init_prob=prior)
    tt = tcat.CategoricalTransition(betas, k, init_prob=prior)
    key = jax.random.key(k)
    want, want_oh, want_log = jt.sample_init((4, 9), key)
    u = np.asarray(jax.random.uniform(key, (4, 9, k), jnp.float32))
    got, got_oh, got_log = tt.sample_init((4, 9), torch.tensor(u))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(np.asarray(want_oh), got_oh.numpy())
    np.testing.assert_array_equal(np.asarray(want_log), got_log.numpy())


@pytest.mark.parametrize("T,S,gamma", [(1000, 100, 1.0), (1000, 25, 3.0), (1000, 1000, 1.0),
                                       (200, 50, 0.5), (20, 10, 2.0), (1000, 1, 1.0)])
def test_respace_equals_jax(T, S, gamma):
    """The copied respacing gives the same kept timesteps and bit-identical
    composed float64 betas, with warped spacing (gamma != 1) too."""
    sub = trespace.respace_timesteps(T, S, gamma)
    np.testing.assert_array_equal(sub, jrespace.respace_timesteps(T, S, gamma))
    betas = jsched.get_beta_schedule(num_timesteps=T, **SEGMENT if T == 1000 else ADVANCE)
    np.testing.assert_array_equal(trespace.respaced_betas(betas, sub),
                                  jrespace.respaced_betas(betas, sub))


@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("t", [0, 1, 250, 999])
def test_ddim_step(t, eta):
    """ddim_prev given the noise JAX draws from the step's key equals JAX's
    to 1e-5; at t = 0 it returns x_recon exactly."""
    betas = jsched.get_beta_schedule(num_timesteps=T, **ADVANCE)
    jt, tt = jgauss.GaussianTransition(betas), tgauss.GaussianTransition(betas)
    rng = np.random.default_rng(t)
    x_t = rng.normal(size=(2, 5, 3)).astype(np.float32)
    x0 = (0.5 * rng.normal(size=(2, 5, 3))).astype(np.float32)
    tv = np.full((2,), t, np.int32)
    key = jax.random.key(t + 1)
    want = jt.ddim_prev(jnp.asarray(x_t), jnp.asarray(x0), jnp.asarray(tv), key, eta=eta)
    noise = np.asarray(jax.random.normal(key, x_t.shape, jnp.float32))
    got = tt.ddim_prev(torch.tensor(x_t), torch.tensor(x0), torch.tensor(tv).long(),
                       torch.tensor(noise), eta=eta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if t == 0:
        np.testing.assert_array_equal(got.numpy(), x0)
