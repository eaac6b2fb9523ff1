"""moldiff_tpu_torch's data-parallel training (one process per rank, gloo on
the CPU) against moldiff_tpu's Trainer on a W-device mesh (GSPMD over the
conftest's virtual CPU devices): one train step at W = 2 and 4 from a
mid-run adam state, fed the noise JAX draws from the same key for the
padded global batch (params rtol 2e-5 / atol 2e-6, loss terms rtol 1e-5
beyond the port's own world-1 distance from JAX);
an odd batch (B = 5, W = 2) with grad_accum 2; the bond predictor's step;
the port at W = 2 against the port at world 1; the eval step's terms; and
the broadcast start (MoE on a data axis: tests/test_torch_expert_parallel.py).
A narrow 2-block model at float32, as tests/test_torch_train.py's."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moldiff_tpu.models.bond_predictor import BondPredictor as JBondPredictor
from moldiff_tpu.models.moldiff import MolDiff as JMolDiff
from moldiff_tpu.models.moldiff import sample_time_antithetic as j_antithetic
from moldiff_tpu.parallel.mesh import make_mesh
from moldiff_tpu.train.trainer import Trainer as JTrainer
from moldiff_tpu.train.trainer import TrainState as JTrainState
from moldiff_tpu.utils.config import load_config
from moldiff_tpu_torch.models.bond_predictor import BondLossNoise
from moldiff_tpu_torch.models.moldiff import LossNoise
from moldiff_tpu_torch.parallel import launch
from moldiff_tpu_torch.train.trainer import Trainer, TrainNoise
from moldiff_tpu_torch.utils.checkpoint import params_to_torch
from moldiff_tpu_torch.utils.tree import tree_leaves
from torch_dist_util import broadcast_worker, make_model, np_batch_to_torch, start_state, \
    train_worker, whole
from torch_port_util import np_tree

TRAIN_CONFIG = "configs/train/train_v2_cont.yml"
BOND_CONFIG = "configs/train/train_bondpred_demo.yml"
N = 8
SPAWN_S = 240


def model_cfg(kind: str = "moldiff") -> dict:
    if kind == "moldiff":
        cfg = copy.deepcopy(load_config(TRAIN_CONFIG).to_dict()["model"])
        cfg.update(node_dim=64, edge_dim=32)
        cfg["denoiser"].update(num_blocks=2, dtype="float32", remat=False)
        return cfg
    cfg = copy.deepcopy(load_config(BOND_CONFIG).to_dict()["model"])
    cfg.update(node_dim=32, edge_dim=16)
    cfg["encoder"].update(num_blocks=2, dtype="float32", remat=False)
    cfg["diff"]["num_timesteps"] = 200
    return cfg


def train_cfg(kind: str = "moldiff", **over) -> dict:
    cfg = copy.deepcopy(load_config(TRAIN_CONFIG if kind == "moldiff" else BOND_CONFIG)
                        .to_dict()["train"])
    cfg.update(over)
    return cfg


TYPES = {"moldiff": (8, 6), "bond": (8, 5)}


def batch(b: int, seed: int = 1, kind: str = "moldiff") -> dict:
    rng = np.random.default_rng(seed)
    sizes = np.array([8, 6, 3, 7, 5, 8, 4, 6][:b])
    mask = (np.arange(N)[None] < sizes[:, None]).astype(np.float32)
    iu, ju = np.triu_indices(N, k=1)
    he_mask = mask[:, iu] * mask[:, ju]
    ke = TYPES[kind][1]
    return {"node_type": (rng.integers(0, 7, (b, N)) * mask).astype(np.int32),
            "pos": (rng.normal(size=(b, N, 3)) * 1.5 * mask[..., None]).astype(np.float32),
            "halfedge_type": (rng.integers(0, min(ke, 5), (b, N * (N - 1) // 2))
                              * he_mask).astype(np.int32),
            "node_mask": mask}


def loss_noise(kind: str, key, b: int, t_max: int):
    """What JAX's get_loss draws from ``key`` for a batch of ``b``."""
    kn, ke = TYPES[kind]
    f = lambda k, shape, fn: torch.tensor(np.asarray(fn(k, shape, jnp.float32)))
    if kind == "bond":
        k_t, k_pos, k_node = jax.random.split(key, 3)
        return BondLossNoise(torch.tensor(np.asarray(j_antithetic(k_t, b, t_max))).long(),
                             f(k_pos, (b, N, 3), jax.random.normal),
                             f(k_node, (b, N, kn), jax.random.uniform))
    k_t, k_pos, k_node, k_edge = jax.random.split(key, 4)
    return LossNoise(torch.tensor(np.asarray(j_antithetic(k_t, b, t_max))).long(),
                     f(k_pos, (b, N, 3), jax.random.normal),
                     f(k_node, (b, N, kn), jax.random.uniform),
                     f(k_edge, (b, N * (N - 1) // 2, ke), jax.random.uniform))


def step_noise(kind: str, key, b_padded: int, accum: int, t_max: int) -> list:
    """What JAX's train step draws from ``key`` (one key per microbatch
    from split(key, accum) when accum > 1; the jitter from each's split)."""
    keys = [key] if accum == 1 else list(jax.random.split(key, accum))
    m = b_padded // accum
    out = []
    for k in keys:
        k, k_jit = jax.random.split(k)
        out.append(TrainNoise(torch.tensor(np.asarray(jax.random.normal(k_jit, (m, N, 3)))),
                              loss_noise(kind, k, m, t_max)))
    return out


def eval_noise(kind: str, key, b_padded: int, t_max: int) -> TrainNoise:
    key, k_jit = jax.random.split(key)
    return TrainNoise(torch.tensor(np.asarray(jax.random.normal(k_jit, (b_padded, N, 3)))),
                      loss_noise(kind, key, b_padded, t_max))


def mid_run(kind: str, params: dict, tcfg: dict, b: dict) -> dict:
    """A state ten steps into a run: adam's count 10, mu 0 and nu 1e-2 x the
    square of each leaf's gradient scale (the update is nearly linear in the
    gradient), EMA a copy of the params."""
    kn, ke = TYPES[kind]
    tr = Trainer(make_model(kind, model_cfg(kind), kn, ke), dict(tcfg, grad_accum=1))
    st = tr.init_from_params(params_to_torch(params, "cpu"))
    t_max = 1000 if kind == "moldiff" else 200
    grads, _, _ = tr.gradient(st, np_batch_to_torch(b),
                              step_noise(kind, jax.random.key(1), len(b["pos"]), 1, t_max)[0])
    nu = [np.full(g.shape, 1e-2 * float(g.abs().max()) ** 2 + 1e-12, np.float32) for g in grads]
    tree = jax.tree.structure(params)
    return {"params": params, "step": 100, "count": 10,
            "mu": jax.tree.map(np.zeros_like, params), "nu": jax.tree.unflatten(tree, nu),
            "ema": params if tcfg.get("ema_decay") else None}


def jax_state(jt, state: dict):
    jp = jax.tree.map(jnp.asarray, state["params"])
    jopt = jt.optimizer.init(jp)
    inner = list(jopt.inner_state)
    adamw = list(inner[-1])
    adamw[0] = adamw[0]._replace(count=jnp.asarray(state["count"], jnp.int32),
                                 mu=jax.tree.map(jnp.asarray, state["mu"]),
                                 nu=jax.tree.map(jnp.asarray, state["nu"]))
    inner[-1] = tuple(adamw)
    ema = jax.tree.map(lambda x: jnp.array(x, copy=True), jp) if state["ema"] is not None else None
    return JTrainState(jp, jopt._replace(inner_state=tuple(inner)),
                       jnp.asarray(state["step"], jnp.int32), ema)


def jax_model(kind: str):
    kn, ke = TYPES[kind]
    return (JMolDiff if kind == "moldiff" else JBondPredictor)(model_cfg(kind), kn, ke)


@pytest.fixture(scope="module")
def params():
    return np_tree(jax_model("moldiff").init_params(jax.random.key(0)))


@pytest.fixture(scope="module")
def bond_params():
    return np_tree(jax_model("bond").init_params(jax.random.key(0)))


def run_world(kind, world, tcfg, state, steps, eval_batch=None, fsdp_modes=(False,),
              ckpt_dir=None):
    kn, ke = TYPES[kind]
    out = launch.spawn(train_worker, world,
                       args=(kind, model_cfg(kind), kn, ke, tcfg, state, steps, eval_batch,
                             fsdp_modes, ckpt_dir), timeout_s=SPAWN_S)
    return out


def assert_state_close(got: dict, jstate, what: str = ""):
    for name, want in (("params", jstate.params), ("ema", jstate.ema_params)):
        if want is None:
            continue
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                tree_leaves(got[name])):
            np.testing.assert_allclose(g, np.asarray(w), rtol=2e-5, atol=2e-6,
                                       err_msg=f"{what} {name} {jax.tree_util.keystr(path)}")


def world_one(kind, tcfg, state, steps) -> tuple:
    """The port's trainer at world 1 on the same steps -> (aux per step,
    whole state per step)."""
    kn, ke = TYPES[kind]
    tr = Trainer(make_model(kind, model_cfg(kind), kn, ke), tcfg)
    st = start_state(tr, state)
    auxs, states = [], []
    for b, noise in steps:
        st, aux = tr.train_step(st, b, noise)
        auxs.append({k: float(v) for k, v in aux.items()})
        states.append(whole(tr, st))
    return auxs, states


def assert_aux_close(got: dict, want: dict, one: dict):
    """Each term within rtol 1e-5 of JAX's on the mesh, beyond the port's
    own float32 distance from it at world 1 (``one``: the port's world-1
    terms; a KL term of nearly equal distributions reads the forward's
    rounding at ~1e-5 relative)."""
    assert set(want) <= set(got), (sorted(got), sorted(want))
    for k, v in want.items():
        v = float(v)
        assert abs(got[k] - v) <= 1e-5 * abs(v) + abs(one[k] - v), (k, got[k], v, one[k])


def _jax_step(kind, world, tcfg, state, b, key):
    jt = JTrainer(jax_model(kind), tcfg, mesh=make_mesh(world))
    jnew, jaux = jt.train_step(jax_state(jt, state), b, key)
    return jt, jnew, jaux


@pytest.fixture(scope="module")
def dp2(params):
    """W = 2: one step on B = 4 and the eval terms on the same batch after
    it; and the same step at world 1 in this process."""
    tcfg = train_cfg(max_grad_norm=1.0)
    b = batch(4)
    state = mid_run("moldiff", params, tcfg, b)
    noise = step_noise("moldiff", jax.random.key(9), 4, 1, 1000)
    ev = eval_noise("moldiff", jax.random.key(5), 4, 1000)
    steps = [(np_batch_to_torch(b), noise)]
    out = run_world("moldiff", 2, tcfg, state, steps, eval_batch=(np_batch_to_torch(b), ev))
    jt, jnew, jaux = _jax_step("moldiff", 2, tcfg, state, b, jax.random.key(9))
    return {"tcfg": tcfg, "batch": b, "state": state, "noise": noise, "eval_noise": ev,
            "ranks": out, "one": world_one("moldiff", tcfg, state, steps),
            "jax": (jt, jnew, jaux)}


def test_dp_step_w2_equals_jax_mesh(dp2):
    """W = 2 against JAX's Trainer on a 2-device mesh (the clip active)."""
    _, jnew, jaux = dp2["jax"]
    assert float(jaux["grad_norm"]) > 1.0
    rec = dp2["ranks"][0][False]
    assert_aux_close(rec["aux"][0], jaux, dp2["one"][0][0])
    assert_state_close(rec["states"][0], jnew, "W=2")
    assert rec["states"][0]["step"] == int(jnew.step)


def test_dp_ranks_hold_equal_params(dp2):
    """Adam and the EMA run identically on every rank: bit-equal states."""
    a, b = (r[False]["states"][0] for r in dp2["ranks"])
    for name in ("params", "ema", "mu", "nu"):
        for x, y in zip(tree_leaves(a[name]), tree_leaves(b[name])):
            np.testing.assert_array_equal(x, y)


def test_dp_w2_equals_port_world_one(dp2):
    """The port at W = 2 against the port at world 1 on the same batch and
    noise: the same step up to the order of its sums."""
    aux, states = dp2["one"]
    rec = dp2["ranks"][0][False]
    for k, v in aux[0].items():
        assert rec["aux"][0][k] == pytest.approx(v, rel=1e-5), k
    for name in ("params", "ema", "mu"):
        for x, y in zip(tree_leaves(rec["states"][0][name]), tree_leaves(states[0][name])):
            np.testing.assert_allclose(x, y, rtol=2e-5, atol=2e-6)


def test_dp_eval_step_equals_jax(dp2):
    """eval_step's terms at W = 2 (every rank the global ones) against
    JAX's eval_step on the 2-device mesh, on the params after the step."""
    jt, jnew, _ = dp2["jax"]
    jaux = jt.eval_step(jnew.params, dp2["batch"], jax.random.key(5))
    kn, ke = TYPES["moldiff"]
    tr = Trainer(make_model("moldiff", model_cfg(), kn, ke), dp2["tcfg"])
    one = tr.eval_step(params_to_torch(dp2["one"][1][0]["params"], "cpu"),
                       np_batch_to_torch(dp2["batch"]), dp2["eval_noise"])
    for r in dp2["ranks"]:
        assert_aux_close(r[False]["eval"], jaux, {k: float(v) for k, v in one.items()})


def test_dp_step_w4_equals_jax_mesh(params):
    """W = 4 (one graph per rank) against JAX's 4-device mesh."""
    tcfg = train_cfg()
    b = batch(4, seed=2)
    state = mid_run("moldiff", params, tcfg, b)
    noise = step_noise("moldiff", jax.random.key(11), 4, 1, 1000)
    steps = [(np_batch_to_torch(b), noise)]
    out = run_world("moldiff", 4, tcfg, state, steps)
    _, jnew, jaux = _jax_step("moldiff", 4, tcfg, state, b, jax.random.key(11))
    one = world_one("moldiff", tcfg, state, steps)[0][0]
    for r in out:
        assert_aux_close(r[False]["aux"][0], jaux, one)
    assert_state_close(out[3][False]["states"][0], jnew, "W=4")


def test_dp_odd_batch_grad_accum(params):
    """B = 5 at W = 2 with grad_accum 2: padded to 8 with masked graphs,
    microbatch i rows [4i, 4i + 4), each rank its half of each."""
    tcfg = train_cfg(grad_accum=2)
    b = batch(5, seed=3)
    state = mid_run("moldiff", params, tcfg, b)
    noise = step_noise("moldiff", jax.random.key(13), 8, 2, 1000)
    steps = [(np_batch_to_torch(b), noise)]
    out = run_world("moldiff", 2, tcfg, state, steps)
    _, jnew, jaux = _jax_step("moldiff", 2, tcfg, state, b, jax.random.key(13))
    # world 1 on the batch padded as the W = 2 step pads it (the noise's rows)
    padded = {k: np.concatenate([v, np.zeros((3,) + v.shape[1:], v.dtype)]) for k, v in b.items()}
    one = world_one("moldiff", tcfg, state, [(np_batch_to_torch(padded), noise)])[0][0]
    assert_aux_close(out[0][False]["aux"][0], jaux, one)
    assert_state_close(out[0][False]["states"][0], jnew, "odd batch")


def test_dp_bond_predictor_step(bond_params):
    """The bond predictor's step at W = 2 (its weighted loss's global
    weight sum, acc_bond's global count) against JAX's 2-device mesh."""
    tcfg = train_cfg("bond")
    b = batch(4, seed=4, kind="bond")
    state = mid_run("bond", bond_params, tcfg, b)
    noise = step_noise("bond", jax.random.key(17), 4, 1, 200)
    steps = [(np_batch_to_torch(b), noise)]
    out = run_world("bond", 2, tcfg, state, steps)
    _, jnew, jaux = _jax_step("bond", 2, tcfg, state, b, jax.random.key(17))
    assert_aux_close(out[1][False]["aux"][0], jaux, world_one("bond", tcfg, state, steps)[0][0])
    assert_state_close(out[1][False]["states"][0], jnew, "bond")


@pytest.mark.parametrize("perturb", [False, True])
def test_broadcast_start(params, perturb):
    """Every rank starts from rank 0's params; a rank whose own differed
    makes every rank raise."""
    kn, ke = TYPES["moldiff"]
    out = launch.spawn(broadcast_worker, 2, args=("moldiff", model_cfg(), kn, ke, train_cfg(),
                                                  params, perturb), timeout_s=SPAWN_S)
    if perturb:
        assert all(o.startswith("error: the params differed on 1 rank") for o in out), out
    else:
        assert out[0] == out[1] and out[0].startswith("ok"), out

