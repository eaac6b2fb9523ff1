"""moldiff_tpu_torch's bond-predictor training against moldiff_tpu's on the
CPU, at a narrow 2-block predictor (node_dim 32, edge_dim 16, T = 200):
BondPredictor.get_loss (loss and acc_bond, also without time) given the
noise JAX draws from the same key, every parameter gradient against
jax.value_and_grad, the bf16 kernel path's plain versions against JAX's
kernel path (Pallas interpreted), and one Trainer.train_step against JAX's
Trainer.train_step, with grad_accum 1 and 2."""
import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models.bond_predictor import BondPredictor as JBondPredictor
from moldiff_tpu.models.moldiff import sample_time_antithetic as j_antithetic
from moldiff_tpu.ops import pallas_kernels
from moldiff_tpu.parallel.mesh import make_mesh
from moldiff_tpu.train.trainer import Trainer as JTrainer
from moldiff_tpu.train.trainer import TrainState as JTrainState
from moldiff_tpu.utils.config import load_config
from moldiff_tpu_torch.models.bond_predictor import BondLossNoise, BondPredictor
from moldiff_tpu_torch.train import optim as toptim
from moldiff_tpu_torch.train.trainer import Trainer, TrainNoise
from moldiff_tpu_torch.utils.checkpoint import params_to_torch
from torch_port_util import jax_tree, np_tree, to_np

CONFIG = "configs/train/train_bondpred_demo.yml"
KN, KE = 8, 5
B, N = 4, 8


def _model_cfg(dtype: str = "float32", pallas: bool = False, num_timesteps: int = 200) -> dict:
    cfg = copy.deepcopy(load_config(CONFIG).to_dict()["model"])
    cfg.update(node_dim=32, edge_dim=16)
    cfg["encoder"].update(num_blocks=2, dtype=dtype, remat=False, use_pallas=pallas,
                          pallas_bwd=pallas)
    cfg["diff"]["num_timesteps"] = num_timesteps
    return cfg


def _train_cfg(**over) -> dict:
    cfg = copy.deepcopy(load_config(CONFIG).to_dict()["train"])
    cfg.update(over)
    return cfg


def _batch(seed: int = 0, b: int = B, n: int = N) -> dict:
    rng = np.random.default_rng(seed)
    sizes = np.array([n, n - 2, n - 5, n - 1, n - 3][:b])
    mask = (np.arange(n)[None] < sizes[:, None]).astype(np.float32)
    iu, ju = np.triu_indices(n, k=1)
    he_mask = mask[:, iu] * mask[:, ju]
    return {"node_type": (rng.integers(0, 7, (b, n)) * mask).astype(np.int32),
            "pos": (rng.normal(size=(b, n, 3)) * 1.5 * mask[..., None]).astype(np.float32),
            "halfedge_type": (rng.integers(0, KE, (b, n * (n - 1) // 2)) * he_mask).astype(
                np.int32),
            "node_mask": mask}


def _torch_batch(batch: dict) -> dict:
    out = {k: torch.tensor(v) for k, v in batch.items()}
    out["node_type"] = out["node_type"].long()
    out["halfedge_type"] = out["halfedge_type"].long()
    return out


def _loss_noise(key, b: int, n: int, num_timesteps: int = 200) -> BondLossNoise:
    """The time draw and noise JAX's get_loss draws from ``key``."""
    if num_timesteps == 0:
        return BondLossNoise(None, None, None)
    k_t, k_pos, k_node = jax.random.split(key, 3)
    return BondLossNoise(
        t=torch.tensor(np.asarray(j_antithetic(k_t, b, num_timesteps))).long(),
        pos=torch.tensor(np.asarray(jax.random.normal(k_pos, (b, n, 3), jnp.float32))),
        node=torch.tensor(np.asarray(jax.random.uniform(k_node, (b, n, KN), jnp.float32))))


def _train_noise(key, b: int, n: int) -> TrainNoise:
    """What JAX's loss_fn draws from ``key`` with pos_noise_std > 0."""
    key, k_jit = jax.random.split(key)
    return TrainNoise(torch.tensor(np.asarray(jax.random.normal(k_jit, (b, n, 3), jnp.float32))),
                      _loss_noise(key, b, n))


@pytest.fixture(scope="module")
def params():
    return np_tree(JBondPredictor(_model_cfg(), KN, KE).init_params(jax.random.key(0)))


def _jax_grads(cfg, params, batch, key):
    jm = JBondPredictor(cfg, KN, KE)

    @jax.jit
    def run(p):
        return jax.value_and_grad(lambda q: jm.get_loss(q, batch["node_type"], batch["pos"],
                                                        batch["halfedge_type"],
                                                        batch["node_mask"], key),
                                  has_aux=True)(p)
    (loss, aux), grads = run(jax_tree(params))
    return float(loss), {k: float(v) for k, v in aux.items()}, grads


def _torch_grads(cfg, params, batch, key):
    tm = BondPredictor(cfg, KN, KE, device="cpu")
    tp = params_to_torch(params, "cpu")
    leaves = toptim.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tb = _torch_batch(batch)
    loss, aux = tm.get_loss(tp, tb["node_type"], tb["pos"], tb["halfedge_type"], tb["node_mask"],
                            _loss_noise(key, *batch["node_type"].shape,
                                        num_timesteps=cfg["diff"]["num_timesteps"]))
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()), {k: float(v.detach()) for k, v in aux.items()},
            toptim.tree_unflatten(tp, grads))


@pytest.fixture(scope="module")
def grads_f32(params):
    batch, key = _batch(0), jax.random.key(7)
    cfg = _model_cfg()
    return _jax_grads(cfg, params, batch, key), _torch_grads(cfg, params, batch, key)


@pytest.mark.parametrize("num_timesteps", [200, 0], ids=["time", "no_time"])
def test_loss_equals_jax(params, grads_f32, num_timesteps):
    """Loss, loss_edge and acc_bond equal JAX's at float32 (rtol 1e-5),
    with the time draw and noise and, with num_timesteps 0, the one-hot
    types and no time."""
    if num_timesteps:
        (loss_j, aux_j, _), (loss_t, aux_t, _) = grads_f32
    else:
        cfg = _model_cfg(num_timesteps=0)
        p0 = np_tree(JBondPredictor(cfg, KN, KE).init_params(jax.random.key(1)))
        batch, key = _batch(2), jax.random.key(3)
        (loss_j, aux_j, _), (loss_t, aux_t, _) = (_jax_grads(cfg, p0, batch, key),
                                                  _torch_grads(cfg, p0, batch, key))
    assert set(aux_t) == set(aux_j) == {"loss", "loss_edge", "acc_bond"}
    for k in aux_j:
        assert aux_t[k] == pytest.approx(aux_j[k], rel=1e-5, abs=1e-7), k
    assert loss_t == pytest.approx(loss_j, rel=1e-5)
    assert 0 < aux_t["acc_bond"] < 1 and math.isfinite(loss_t)


def test_every_gradient_f32(grads_f32):
    """Every parameter gradient equals jax.grad of JAX's get_loss (XLA
    path) to 1e-4 of the leaf's scale."""
    (_, _, gj), (_, _, gt) = grads_f32
    paths = jax.tree_util.tree_flatten_with_path(gj)[0]
    assert len(paths) == len(toptim.tree_leaves(gt))
    for (path, w), g in zip(paths, toptim.tree_leaves(gt)):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        scale = np.abs(w).max() + 1e-12
        assert np.abs(to_np(g) - w).max() <= 1e-4 * scale, (jax.tree_util.keystr(path),
                                                              np.abs(to_np(g) - w).max(), scale)


def test_every_gradient_bf16_kernel_path(params, grads_f32):
    """bf16 compute: the port's kernel path (plain versions of rows 1, 4
    forward and rows 3, 5 in full mode, parameter gradients included)
    against the float32 truth, within 2x the error of JAX's own kernel path
    (use_pallas + pallas_bwd, Pallas in interpret mode) summed over leaves,
    and per leaf within 4x (or 1e-2 of the leaf's scale), the rule of
    test_torch_train.py's test_every_gradient_bf16_kernel_path."""
    (_, _, truth), _ = grads_f32
    batch, key = _batch(0), jax.random.key(7)
    saved = pallas_kernels.INTERPRET
    pallas_kernels.INTERPRET = True
    try:
        loss_j, _, gj = _jax_grads(_model_cfg("bfloat16", pallas=True), params, batch, key)
    finally:
        pallas_kernels.INTERPRET = saved
    loss_t, _, gt = _torch_grads(_model_cfg("bfloat16"), params, batch, key)
    assert math.isfinite(loss_t) and loss_t == pytest.approx(loss_j, rel=2e-2)
    errs = []
    for (path, t), g, w in zip(jax.tree_util.tree_flatten_with_path(truth)[0],
                               toptim.tree_leaves(gt), jax.tree.leaves(gj)):
        t = np.asarray(t, np.float32)
        scale = np.abs(t).max() + 1e-12
        errs.append((jax.tree_util.keystr(path), np.abs(to_np(g) - t).max() / scale,
                     np.abs(np.asarray(w, np.float32) - t).max() / scale))
    assert sum(e for _, e, _ in errs) <= 2 * sum(w for _, _, w in errs)
    for path, e, w in errs:
        assert e <= max(4 * w, 1e-2), (path, e, w)


def _mid_run_states(jt, tt, params, grads):
    """The same state in both frameworks, ten steps into a run: adam's
    count 10, mu 0 and nu 1e-2 x the square of each leaf's gradient scale,
    so that the update is nearly linear in the gradient, about 0.1 x lr at
    the leaf's largest element (a first step's is its sign, which float32
    rounding flips where a gradient element is near 0)."""
    jp = jax_tree(params)
    nu = jax.tree.map(lambda p, g: jnp.full(p.shape, 1e-2 * float(np.abs(np.asarray(g)).max())
                                            ** 2 + 1e-12, jnp.float32), jp, grads)
    jopt = jt.optimizer.init(jp)
    inner = list(jopt.inner_state)
    adamw = list(inner[-1])
    adamw[0] = adamw[0]._replace(count=jnp.asarray(10, jnp.int32),
                                 mu=jax.tree.map(jnp.zeros_like, jp), nu=nu)
    inner[-1] = tuple(adamw)
    jstate = JTrainState(jp, jopt._replace(inner_state=tuple(inner)),
                         jnp.asarray(40000, jnp.int32), None)
    tstate = tt.init_from_params(params_to_torch(params, "cpu"), 40000)
    tstate.opt_state.count = 10
    tstate.opt_state.nu = params_to_torch(np_tree(nu), "cpu")
    return jstate, tstate


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_equals_jax_trainer(params, grads_f32, accum):
    """One step of the port's Trainer (float32) equals JAX's
    Trainer.train_step from the same mid-run state and key (its jitter and
    loss noise; with grad_accum 2, one key per microbatch from
    split(key, 2)): the loss terms (averaged over microbatches), the grad
    norm and the params after the step (rtol 2e-5, atol 2e-6)."""
    cfg = _model_cfg()
    train_cfg = _train_cfg(grad_accum=accum)
    batch, key = _batch(1), jax.random.key(9)
    jt = JTrainer(JBondPredictor(cfg, KN, KE), train_cfg, mesh=make_mesh(1))
    tt = Trainer(BondPredictor(cfg, KN, KE, device="cpu"), train_cfg)
    assert tt.grad_accum == jt.grad_accum == accum
    jstate, tstate = _mid_run_states(jt, tt, params, grads_f32[0][2])
    jnew, jaux = jt.train_step(jstate, batch, key)
    if accum == 1:
        noise = _train_noise(key, B, N)
    else:
        noise = [_train_noise(k, B // accum, N) for k in jax.random.split(key, accum)]
    tnew, taux = tt.train_step(tstate, _torch_batch(batch), noise)
    assert tnew.step == int(jnew.step) == 40001 and tnew.opt_state.count == 11
    for k, v in jaux.items():
        assert float(taux[k]) == pytest.approx(float(v), rel=1e-4), k
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jnew.params)[0],
                            toptim.tree_leaves(tnew.params)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=2e-5, atol=2e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_grad_accum_pads_an_odd_batch(params):
    """An odd batch with grad_accum 4 is padded with fully masked graphs
    (5 -> 8, one microbatch nearly empty) and still trains: every loss term
    finite, the step taken (tests/test_train.py's check)."""
    cfg = _model_cfg()
    tt = Trainer(BondPredictor(cfg, KN, KE, device="cpu"), _train_cfg(grad_accum=4))
    batch = _torch_batch(_batch(3, b=5))
    gen = torch.Generator().manual_seed(0)
    noise = tt.draw_step_noise(batch, gen)
    assert len(noise) == 4 and noise[0].loss.pos.shape == (2, N, 3)
    state, aux = tt.train_step(tt.init_from_params(params_to_torch(params, "cpu")), batch, noise)
    assert state.step == 1 and all(math.isfinite(float(v)) for v in aux.values()), aux
    assert not all(torch.equal(a, b) for a, b in zip(toptim.tree_leaves(state.params),
                                                     toptim.tree_leaves(params_to_torch(
                                                         params, "cpu"))))
    vaux = tt.eval_step(state.params, batch, tt.draw_noise(batch, gen))
    assert math.isfinite(float(vaux["loss"]))
