"""moldiff_tpu_torch's training path against moldiff_tpu on the CPU: the
loss and every parameter gradient (JAX's get_loss under jax.value_and_grad
given the same batch, time draw and noise), the optimizer and schedulers
(optax's chain and the JAX package's classes), one whole train step
(JAX's Trainer.train_step), the checkpoint (read back by the JAX loaders
and the port's sampler) and the train CLI.

The gradient tests run a narrow 2-block flagship-style model (node_dim 64,
edge_dim 32, bond_len_loss and update_pos on): at float32 against the XLA
path per leaf to 1e-4 of the leaf's scale; at bf16, the port's kernel path
(plain versions on the CPU) against JAX's kernel path (Pallas in interpret
mode), both against the float32 truth."""
import copy
import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models.moldiff import MolDiff as JMolDiff
from moldiff_tpu.models.moldiff import sample_time_antithetic as j_antithetic
from moldiff_tpu.ops import pallas_kernels
from moldiff_tpu.parallel.mesh import make_mesh
from moldiff_tpu.train import optim as joptim
from moldiff_tpu.train.trainer import Trainer as JTrainer
from moldiff_tpu.train.trainer import TrainState as JTrainState
from moldiff_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from moldiff_tpu.train.trainer import save_checkpoint as jax_save_checkpoint
from moldiff_tpu.utils.config import load_config
from moldiff_tpu_torch.models.moldiff import LossNoise, MolDiff, sample_time_antithetic
from moldiff_tpu_torch.train import optim as toptim
from moldiff_tpu_torch.train.trainer import Trainer, TrainNoise
from moldiff_tpu_torch.utils.checkpoint import params_to_torch
from torch_port_util import np_tree, to_np

TRAIN_CONFIG = "configs/train/train_v2_cont.yml"
B, N = 3, 8
E = N * (N - 1) // 2


def _small_model_cfg(dtype: str, pallas: bool = False) -> dict:
    cfg = copy.deepcopy(load_config(TRAIN_CONFIG).to_dict()["model"])
    cfg.update(node_dim=64, edge_dim=32)
    cfg["denoiser"].update(num_blocks=2, dtype=dtype, remat=False, use_pallas=pallas,
                           pallas_bwd=pallas)
    return cfg


def _batch(seed: int = 0, b: int = B, n: int = N) -> dict:
    rng = np.random.default_rng(seed)
    sizes = np.array([n, n - 2, n - 5][:b])
    mask = (np.arange(n)[None] < sizes[:, None]).astype(np.float32)
    iu, ju = np.triu_indices(n, k=1)
    he_mask = mask[:, iu] * mask[:, ju]
    return {"node_type": (rng.integers(0, 7, (b, n)) * mask).astype(np.int32),
            "pos": (rng.normal(size=(b, n, 3)) * 1.5 * mask[..., None]).astype(np.float32),
            "halfedge_type": (rng.integers(0, 5, (b, n * (n - 1) // 2)) * he_mask).astype(
                np.int32),
            "node_mask": mask}


def _loss_noise(key, b: int, n: int, num_timesteps: int = 1000) -> LossNoise:
    """The time draw and noise JAX's get_loss draws from ``key``."""
    k_t, k_pos, k_node, k_edge = jax.random.split(key, 4)
    e = n * (n - 1) // 2
    t = np.asarray(j_antithetic(k_t, b, num_timesteps))
    return LossNoise(
        t=torch.tensor(t).long(),
        pos=torch.tensor(np.asarray(jax.random.normal(k_pos, (b, n, 3), jnp.float32))),
        node=torch.tensor(np.asarray(jax.random.uniform(k_node, (b, n, 8), jnp.float32))),
        edge=torch.tensor(np.asarray(jax.random.uniform(k_edge, (b, e, 6), jnp.float32))))


def _torch_batch(batch: dict) -> dict:
    out = {k: torch.tensor(v) for k, v in batch.items()}
    out["node_type"] = out["node_type"].long()
    out["halfedge_type"] = out["halfedge_type"].long()
    return out


@pytest.fixture(scope="module")
def small_params():
    return np_tree(JMolDiff(_small_model_cfg("float32"), 8, 6).init_params(jax.random.key(0)))


def _jax_grads(cfg, params, batch, key):
    jm = JMolDiff(cfg, 8, 6)

    @jax.jit
    def run(p):
        return jax.value_and_grad(lambda q: jm.get_loss(q, batch["node_type"], batch["pos"],
                                                        batch["halfedge_type"],
                                                        batch["node_mask"], key),
                                  has_aux=True)(p)
    (loss, aux), grads = run(jax.tree.map(jnp.asarray, params))
    return float(loss), {k: float(v) for k, v in aux.items()}, grads


def _torch_grads(cfg, params, batch, key):
    tm = MolDiff(cfg, 8, 6, device="cpu")
    tp = params_to_torch(params, "cpu")
    leaves = toptim.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tb = _torch_batch(batch)
    loss, aux = tm.get_loss(tp, tb["node_type"], tb["pos"], tb["halfedge_type"],
                            tb["node_mask"], _loss_noise(key, *batch["node_type"].shape))
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()), {k: float(v.detach()) for k, v in aux.items()},
            toptim.tree_unflatten(tp, grads))


def _leaf_errors(got, want, truth):
    """(path, |got - truth| / scale, |want - truth| / scale) per leaf."""
    out = []
    for (path, t), g, w in zip(jax.tree_util.tree_flatten_with_path(truth)[0],
                               toptim.tree_leaves(got), jax.tree.leaves(want)):
        t = np.asarray(t, np.float32)
        scale = np.abs(t).max() + 1e-12
        out.append((jax.tree_util.keystr(path), np.abs(to_np(g) - t).max() / scale,
                    np.abs(np.asarray(w, np.float32) - t).max() / scale))
    return out


@pytest.fixture(scope="module")
def grads_f32(small_params):
    batch, key = _batch(0), jax.random.key(7)
    cfg = _small_model_cfg("float32")
    return _jax_grads(cfg, small_params, batch, key), _torch_grads(cfg, small_params, batch, key)


def test_loss_terms_f32(grads_f32):
    """The loss and each of its terms (pos, node, edge, bond length) equal
    JAX's at float32."""
    (loss_j, aux_j, _), (loss_t, aux_t, _) = grads_f32
    assert set(aux_t) == set(aux_j) >= {"loss", "loss_pos", "loss_node", "loss_edge",
                                        "loss_len"}
    for k in aux_j:
        assert aux_t[k] == pytest.approx(aux_j[k], rel=1e-5, abs=1e-7), k
    assert loss_t == pytest.approx(loss_j, rel=1e-5)


def test_every_gradient_f32(grads_f32):
    """Every parameter gradient equals jax.grad of JAX's get_loss (XLA path)
    to 1e-4 of the leaf's scale, the blocks' PosUpdate leaves and the
    earlier blocks' leaves (reached through d_rel_vec and d_distance)
    included."""
    (_, _, gj), (_, _, gt) = grads_f32
    paths = jax.tree_util.tree_flatten_with_path(gj)[0]
    assert len(paths) == len(toptim.tree_leaves(gt))
    for (path, w), g in zip(paths, toptim.tree_leaves(gt)):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        scale = np.abs(w).max() + 1e-12
        assert np.abs(to_np(g) - w).max() <= 1e-4 * scale, (jax.tree_util.keystr(path),
                                                              np.abs(to_np(g) - w).max(), scale)


def test_every_gradient_bf16_kernel_path(small_params, grads_f32):
    """bf16 compute: the port's kernel path (plain versions on the CPU)
    against the float32 truth, within 2x the error of JAX's own kernel path
    (use_pallas + pallas_bwd, Pallas in interpret mode) summed over leaves,
    and per leaf within 4x (or 1e-2 of the leaf's scale: a relu boundary
    flip moves a small leaf's largest error by several times, the reason the
    JAX package's own PosUpdate test bounds leaves this way)."""
    (_, _, truth), _ = grads_f32
    batch, key = _batch(0), jax.random.key(7)
    saved = pallas_kernels.INTERPRET
    pallas_kernels.INTERPRET = True
    try:
        loss_j, _, gj = _jax_grads(_small_model_cfg("bfloat16", pallas=True), small_params,
                                   batch, key)
    finally:
        pallas_kernels.INTERPRET = saved
    loss_t, _, gt = _torch_grads(_small_model_cfg("bfloat16"), small_params, batch, key)
    assert math.isfinite(loss_t) and loss_t == pytest.approx(loss_j, rel=2e-2)
    errs = _leaf_errors(gt, gj, truth)
    assert sum(e for _, e, _ in errs) <= 2 * sum(w for _, _, w in errs)
    for path, e, w in errs:
        assert e <= max(4 * w, 1e-2), (path, e, w)


@pytest.mark.parametrize("flag", ["edge_full", "fuse_block"])
def test_every_gradient_f32_route(small_params, grads_f32, flag):
    """float32 with edge_full (rows 6 and 7) or fuse_block (row 2 forward,
    the partial path's block differentiated): every parameter gradient
    equals jax.grad of JAX's get_loss (XLA path) to 1e-4 of the leaf's
    scale, as test_every_gradient_f32."""
    (_, _, gj), _ = grads_f32
    cfg = _small_model_cfg("float32")
    cfg["denoiser"][flag] = True
    _, _, gt = _torch_grads(cfg, small_params, _batch(0), jax.random.key(7))
    paths = jax.tree_util.tree_flatten_with_path(gj)[0]
    assert len(paths) == len(toptim.tree_leaves(gt))
    for (path, w), g in zip(paths, toptim.tree_leaves(gt)):
        w = np.asarray(w, np.float32)
        scale = np.abs(w).max() + 1e-12
        assert np.abs(to_np(g) - w).max() <= 1e-4 * scale, (jax.tree_util.keystr(path),
                                                              np.abs(to_np(g) - w).max(), scale)


def test_every_gradient_bf16_edge_full_kernel_path(small_params, grads_f32):
    """bf16 compute with edge_full: the port's full-EdgeBlock path (plain
    versions on the CPU) against the float32 truth, within 2x the error of
    JAX's own edge_full path (use_pallas + pallas_bwd + edge_full, Pallas in
    interpret mode) summed over leaves, and per leaf within 4x (or 1e-2 of
    the leaf's scale), the rule of test_every_gradient_bf16_kernel_path."""
    (_, _, truth), _ = grads_f32
    batch, key = _batch(0), jax.random.key(7)
    jcfg = _small_model_cfg("bfloat16", pallas=True)
    jcfg["denoiser"]["edge_full"] = True
    saved = pallas_kernels.INTERPRET
    pallas_kernels.INTERPRET = True
    try:
        loss_j, _, gj = _jax_grads(jcfg, small_params, batch, key)
    finally:
        pallas_kernels.INTERPRET = saved
    tcfg = _small_model_cfg("bfloat16")
    tcfg["denoiser"]["edge_full"] = True
    loss_t, _, gt = _torch_grads(tcfg, small_params, batch, key)
    assert math.isfinite(loss_t) and loss_t == pytest.approx(loss_j, rel=2e-2)
    errs = _leaf_errors(gt, gj, truth)
    assert sum(e for _, e, _ in errs) <= 2 * sum(w for _, _, w in errs)
    for path, e, w in errs:
        assert e <= max(4 * w, 1e-2), (path, e, w)


def test_loss_on_flagship_weights():
    """The loss on the committed flagship_v2 weights at B = 2, N = 32 (float32)
    equals JAX's, term by term."""
    ck = jax_load_checkpoint("ckpts/flagship_v2.ckpt")
    cfg = copy.deepcopy(dict(ck["config"]["model"]))
    cfg["denoiser"] = dict(cfg["denoiser"], dtype="float32", remat=False)
    batch, key = _batch(3, b=2, n=32), jax.random.key(3)
    jm = JMolDiff(cfg, 8, 6)
    _, aux_j = jax.jit(lambda p: jm.get_loss(p, batch["node_type"], batch["pos"],
                                             batch["halfedge_type"], batch["node_mask"],
                                             key))(ck["params"])
    tm = MolDiff(cfg, 8, 6, device="cpu")
    tb = _torch_batch(batch)
    with torch.no_grad():
        _, aux_t = tm.get_loss(params_to_torch(ck["params"], "cpu"), tb["node_type"], tb["pos"],
                               tb["halfedge_type"], tb["node_mask"], _loss_noise(key, 2, 32))
    for k, v in aux_j.items():
        assert float(aux_t[k]) == pytest.approx(float(v), rel=1e-4), k


def test_antithetic_time_draw():
    key = jax.random.key(5)
    half = jax.random.randint(key, (B // 2 + 1,), 0, 1000)
    want = np.asarray(j_antithetic(key, B, 1000))
    got = sample_time_antithetic(torch.tensor(np.asarray(half)), B, 1000)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# optimizer and schedulers
# ---------------------------------------------------------------------------

OPT_CFG = {"type": "adamw", "lr": 3e-5, "weight_decay": 1e-8, "beta1": 0.99, "beta2": 0.999}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clip_active", "clip_inactive"])
def test_optimizer_equals_optax(steps, max_norm):
    """adamw behind clip-by-global-norm, one and three steps, with the clip
    active and inactive: parameters and moments equal optax's chain from
    moldiff_tpu.train.optim to float32 rounding."""
    rng = np.random.default_rng(steps)
    params = {"a": {"w": rng.normal(size=(5, 4)).astype(np.float32)},
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.3).astype(np.float32), params)
             for _ in range(steps)]
    cfg = dict(OPT_CFG, max_grad_norm=max_norm)
    jopt = joptim.get_optimizer(cfg)
    jp, js = jax.tree.map(jnp.asarray, params), jopt.init(jax.tree.map(jnp.asarray, params))
    topt = toptim.Optimizer(cfg)
    tp = params_to_torch(params, "cpu")
    ts = topt.init(tp)
    for g in grads:
        norm = math.sqrt(sum(float((x ** 2).sum()) for x in jax.tree.leaves(g)))
        assert (norm > max_norm) == (max_norm < 1)
        upd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        tp, ts = topt.update(params_to_torch(g, "cpu"), ts, tp)
    for w, t in zip(jax.tree.leaves(jp), toptim.tree_leaves(tp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)
    adam = js.inner_state[-1][0]
    for w, t in zip(jax.tree.leaves(adam.mu), toptim.tree_leaves(ts.mu)):
        # XLA may fuse (1 - b1) g + b1 m into one FMA: float32 rounding of
        # the leaf's scale where the two terms cancel
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(w)).max())
    assert ts.count == int(adam.count) == steps
    assert toptim.get_lr(ts) == pytest.approx(joptim.get_lr(js))


SCHEDULERS = {
    "plateau": {"type": "plateau", "factor": 0.8, "patience": 2, "min_lr": 1e-5},
    "warmup_plateau": {"type": "warmup_plateau", "multiplier": 2.0, "total_epoch": 3,
                       "factor": 0.5, "patience": 1, "min_lr": 1e-5},
    "expmin": {"type": "expmin", "factor": 0.9, "min_lr": 2e-5},
    "expmin_milestone": {"type": "expmin_milestone", "factor": 0.9, "min_lr": 2e-5,
                         "milestone": 4},
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_equals_jax(name):
    """Each scheduler against its JAX class over one sequence of validation
    losses: the same learning rates and state dicts."""
    losses = [5.0, 4.0, 4.5, 4.6, 4.7, 3.9, 4.0, 4.1, 4.2, 4.3, 3.0]
    js, ts = joptim.get_scheduler(SCHEDULERS[name], 3e-5), toptim.get_scheduler(
        SCHEDULERS[name], 3e-5)
    lr_j = lr_t = 3e-5
    for v in losses:
        lr_j, lr_t = js.step(v, lr_j), ts.step(v, lr_t)
        assert lr_t == lr_j
    assert ts.state_dict() == js.state_dict()
    ts.reset()
    js.reset()
    assert ts.state_dict() == js.state_dict()


# ---------------------------------------------------------------------------
# train step, checkpoint, CLI
# ---------------------------------------------------------------------------

def _train_cfg(**over) -> dict:
    cfg = copy.deepcopy(load_config(TRAIN_CONFIG).to_dict()["train"])
    cfg.update(over)
    return cfg


def test_train_step_equals_jax_trainer(small_params):
    """One step of the port's trainer (f32) equals JAX's Trainer.train_step
    from the same state and key (its jitter and loss noise): the loss terms,
    the grad norm before clipping, the new parameters, the EMA and the
    optimizer's moments."""
    cfg = _small_model_cfg("float32")
    train_cfg = _train_cfg(max_grad_norm=1.0)
    batch, key = _batch(1), jax.random.key(9)
    jt = JTrainer(JMolDiff(cfg, 8, 6), train_cfg, mesh=make_mesh(1))
    jp = jax.tree.map(jnp.asarray, small_params)
    jstate = JTrainState(jp, jt.optimizer.init(jp), jnp.asarray(300000, jnp.int32),
                         jax.tree.map(lambda x: jnp.array(x, copy=True), jp))
    jnew, jaux = jt.train_step(jstate, batch, key)

    tm = MolDiff(cfg, 8, 6, device="cpu")
    tt = Trainer(tm, train_cfg)
    tstate = tt.init_from_params(params_to_torch(small_params, "cpu"), 300000)
    key2, k_jit = jax.random.split(key)
    noise = TrainNoise(torch.tensor(np.asarray(jax.random.normal(k_jit, (B, N, 3)))),
                       _loss_noise(key2, B, N))
    tnew, taux = tt.train_step(tstate, _torch_batch(batch), noise)
    assert tnew.step == int(jnew.step) == 300001
    assert float(jaux["grad_norm"]) > 1.0  # the clip was active
    for k, v in jaux.items():
        assert float(taux[k]) == pytest.approx(float(v), rel=1e-4), k
    lr, b1 = train_cfg["optimizer"]["lr"], train_cfg["optimizer"]["beta1"]
    adam = jnew.opt_state.inner_state[-1][0]
    # adam's first update is lr * g / (|g| + 1e-8) per element: compare the
    # updates to 1 % of lr where the clipped gradient is well above adam's
    # eps; where it is not, gradient rounding moves the update anywhere in
    # [-lr, lr] (and the EMA's by 1e-3 of that)
    for name, want, got, frac in (("params", jnew.params, tnew.params, 1.0),
                                  ("ema", jnew.ema_params, tnew.ema_params, 1e-3)):
        for (path, w), g, p0, mu in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                        toptim.tree_leaves(got), jax.tree.leaves(small_params),
                                        jax.tree.leaves(adam.mu)):
            dw, dg = np.asarray(w) - p0, to_np(g) - p0
            ulp = 4 * np.spacing(np.abs(p0).max())     # float32 rounding of p + u
            big = np.abs(np.asarray(mu)) / (1 - b1) > 1e-6
            assert np.abs(dg - dw)[big].max(initial=0) <= 1e-2 * lr * frac + ulp, (
                name, jax.tree_util.keystr(path))
            assert np.abs(dg - dw).max() <= 2 * lr * frac + ulp, (
                name, jax.tree_util.keystr(path))
    for w, g in zip(jax.tree.leaves(adam.mu), toptim.tree_leaves(tnew.opt_state.mu)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=2e-3,
                                   atol=2e-3 * np.abs(np.asarray(w)).max() + 1e-12)


def test_checkpoint_loads_in_jax_and_port(small_params, tmp_path):
    """The port's checkpoint is a JAX distribution checkpoint: both JAX
    loaders read params and EMA leaf for leaf (a fresh optax state), the
    port resumes its own moments and learning rate, and the port's sampler
    reads it."""
    from moldiff_tpu_torch.sample import cli as sample_cli

    full = load_config(TRAIN_CONFIG).to_dict()
    full["model"] = _small_model_cfg("float32")
    train_cfg = _train_cfg()
    tt = Trainer(MolDiff(full["model"], 8, 6, device="cpu"), train_cfg)
    state = tt.init_from_params(params_to_torch(small_params, "cpu"), 12)
    state.opt_state.mu = toptim.tree_map(lambda p: torch.full_like(p, 0.5), state.params)
    state.opt_state.count = 4
    toptim.set_lr(state.opt_state, 2e-5)
    tt.scheduler.step(1.0, 2e-5)
    path = str(tmp_path / "port.ckpt")
    tt.save_checkpoint(path, state, full)

    blob = jax_load_checkpoint(path)
    assert blob["opt_state"] is None and blob["key"] is None and blob["step"] == 12
    assert blob["scheduler"] == tt.scheduler.state_dict()
    jt = JTrainer(JMolDiff(full["model"], 8, 6), train_cfg, mesh=make_mesh(1))
    jstate = jt.load_checkpoint(path)
    assert int(jstate.step) == 12 and joptim.get_lr(jstate.opt_state) == pytest.approx(3e-5)
    for tree in (blob["params"], blob["ema_params"], jstate.params):
        for w, t in zip(jax.tree.leaves(tree), jax.tree.leaves(small_params)):
            np.testing.assert_array_equal(np.asarray(w), t)

    tt2 = Trainer(MolDiff(full["model"], 8, 6, device="cpu"), train_cfg)
    back = tt2.load_checkpoint(path, "cpu")
    assert back.opt_state.count == 4 and back.opt_state.lr == 2e-5 and back.step == 12
    assert all(bool((m == 0.5).all()) for m in toptim.tree_leaves(back.opt_state.mu))
    assert tt2.scheduler.state_dict() == tt.scheduler.state_dict()
    sampler, params = sample_cli.build_sampler(path, {"buckets": [8], "batch_size": 2},
                                               torch.device("cpu"))
    assert sampler.model.denoiser_static["num_blocks"] == 2
    assert len(toptim.tree_leaves(params)) == len(jax.tree.leaves(small_params))


def test_cli_fine_tunes_on_cpu(small_params, tmp_path):
    """The train CLI on the CPU with a tiny config, resumed from a JAX
    checkpoint at step 0: 3 steps, one validation (which steps the
    scheduler) and one checkpoint, every loss finite; and without a
    checkpoint, 2 steps from fresh params."""
    from moldiff_tpu_torch.train import cli as train_cli

    full = load_config(TRAIN_CONFIG).to_dict()
    full["model"] = _small_model_cfg("float32")
    full["train"].update(batch_size=4, buckets=[16, 24, 32], val_freq=3, val_batches=1,
                         ckpt_freq=3)
    full["dataset"]["root"] = "./data/synthetic"   # the demo corpus (v1): fast to make
    resume = str(tmp_path / "init.ckpt")
    jp = jax.tree.map(jnp.asarray, small_params)
    jax_save_checkpoint(resume, JTrainState(jp, None, jnp.asarray(0, jnp.int32), None),
                        model_config=full)
    logs = []
    out = train_cli.run(full, resume, device="cpu", logdir=str(tmp_path / "logs"),
                        max_iters=3, corpus_mols=40, log=logs.append)
    assert [s["it"] for s in out["steps"]] == [1, 2, 3]
    assert all(math.isfinite(s["loss"]) and s["grad_norm"] > 0 for s in out["steps"])
    assert len(out["val"]) == 1 and math.isfinite(out["val"][0]["loss"])
    assert [p.rsplit("/", 1)[-1] for p in out["checkpoints"]] == ["3.ckpt"]
    assert any(m.startswith("[it 1] loss") for m in logs)
    with open(out["checkpoints"][0], "rb") as f:
        blob = pickle.load(f)
    assert blob["step"] == 3 and blob["extra"]["optimizer"]["count"] == 3
    assert jax_load_checkpoint(out["checkpoints"][0])["step"] == 3
    # without a checkpoint the run starts from fresh params and takes its steps
    scratch = train_cli.run(full, None, device="cpu", logdir=str(tmp_path / "logs"),
                            max_iters=2, corpus_mols=40, log=logs.append)
    assert [s["it"] for s in scratch["steps"]] == [1, 2]
    assert all(math.isfinite(s["loss"]) and s["grad_norm"] > 0 for s in scratch["steps"])
    assert any(m.startswith("initialised from train.seed") for m in logs)


def test_entry_point_defaults_to_cuda(small_params, tmp_path):
    """Without a card the CLI refuses the default device instead of falling
    back to the CPU."""
    from moldiff_tpu_torch.train import cli as train_cli

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    full = load_config(TRAIN_CONFIG).to_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.run(full, "ckpts/flagship_v2.ckpt", logdir=str(tmp_path))
