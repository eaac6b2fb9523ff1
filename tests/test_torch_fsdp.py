"""moldiff_tpu_torch's fully sharded data-parallel training (``parallel.fsdp``:
params, adam moments and EMA sharded over the data axis at rest, the
params gathered once a step, the gradients reduce-scattered) at W = 2 gloo
processes on the CPU: two steps equal to the data-parallel run (rtol 1e-6)
and to JAX's Trainer(fsdp=True) on a 2-device mesh (params rtol 2e-5 /
atol 2e-6, loss terms rtol 1e-5 beyond the port's world-1 distance), the
shard shapes of params, moments and EMA against JAX's placement, and a
step resumed from a sharded checkpoint equal to the step continued."""
import jax
import numpy as np
import pytest

from moldiff_tpu.parallel.mesh import fsdp_param_sharding as j_fsdp, make_mesh
from moldiff_tpu.train.trainer import Trainer as JTrainer
from moldiff_tpu_torch.utils.tree import tree_leaves
from test_torch_data_parallel import (assert_aux_close, assert_state_close, batch, jax_model,
                                      jax_state, mid_run, run_world, step_noise, train_cfg,
                                      world_one)
from torch_dist_util import np_batch_to_torch
from torch_port_util import np_tree


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    params = np_tree(jax_model("moldiff").init_params(jax.random.key(0)))
    tcfg = train_cfg(max_grad_norm=1.0)
    bs = [batch(4, seed=s) for s in (5, 6, 7)]
    keys = [jax.random.key(k) for k in (21, 22, 23)]
    state = mid_run("moldiff", params, tcfg, bs[0])
    steps = [(np_batch_to_torch(b), step_noise("moldiff", k, 4, 1, 1000))
             for b, k in zip(bs, keys)]
    ckpt = str(tmp_path_factory.mktemp("fsdp") / "2.ckpt")
    out = run_world("moldiff", 2, tcfg, state, steps, fsdp_modes=(False, True), ckpt_dir=ckpt)
    jt = JTrainer(jax_model("moldiff"), tcfg, mesh=make_mesh(2), fsdp=True)
    js = jax_state(jt, state)
    js = jax.device_put(js, jt._state_sharding(js))
    jstates, jauxs = [], []
    for b, k in zip(bs[:2], keys[:2]):
        js, aux = jt.train_step(js, b, k)
        # the step donates its input state: keep host copies
        jstates.append(jax.tree.map(np.asarray, js))
        jauxs.append({key: float(v) for key, v in aux.items()})
    return {"ranks": out, "jax": (jstates, jauxs), "params": params, "ckpt": ckpt,
            "one": world_one("moldiff", tcfg, state, steps[:2])}


def test_fsdp_equals_data_parallel(fsdp_run):
    """FSDP's two steps equal the data-parallel run's at rtol 1e-6 (and 1e-6
    of each leaf's scale): the same sums, but the grad norm from
    all-reduced squares, whose last bit moves the clip factor."""
    dp, fs = fsdp_run["ranks"][0][False], fsdp_run["ranks"][0][True]
    for i in range(2):
        for k, v in dp["aux"][i].items():
            assert fs["aux"][i][k] == pytest.approx(v, rel=1e-6), (i, k)
        for name in ("params", "ema", "mu", "nu"):
            for x, y in zip(tree_leaves(fs["states"][i][name]),
                            tree_leaves(dp["states"][i][name])):
                # atol: 1e-6 of the leaf's scale, for the elements where
                # adam's two terms cancel (the clip factor's last bit)
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6 * np.abs(y).max(),
                                           err_msg=f"step {i + 1} {name}")


def test_fsdp_equals_jax_fsdp_trainer(fsdp_run):
    jstates, jauxs = fsdp_run["jax"]
    fs = fsdp_run["ranks"][1][True]
    for i in range(2):
        assert_aux_close(fs["aux"][i], jauxs[i], fsdp_run["one"][0][i])
        assert_state_close(fs["states"][i], jstates[i], f"fsdp step {i + 1}")


def test_fsdp_shard_shapes_are_jax_placement(fsdp_run):
    """Each rank holds the shard JAX's fsdp_param_sharding places on its
    device: params, adam moments and EMA alike."""
    params = fsdp_run["params"]
    want = [tuple(s.shard_shape(np.shape(x))) for s, x in
            zip(jax.tree.leaves(j_fsdp(make_mesh(2), params)), jax.tree.leaves(params))]
    assert any(w != np.shape(x) for w, x in zip(want, jax.tree.leaves(params)))
    for r in fsdp_run["ranks"]:
        for name in ("params", "mu", "ema"):
            assert r[True]["shapes"][name] == want, name
    assert fsdp_run["ranks"][0][False]["shapes"]["params"] == [np.shape(x) for x in
                                                               jax.tree.leaves(params)]


def test_fsdp_resume_from_sharded_checkpoint(fsdp_run):
    """The step taken after reloading the sharded checkpoint of step 2 is
    bit-equal to the step taken without it."""
    fs = fsdp_run["ranks"][0][True]
    back = fs["resumed"]
    assert back["step"] == 102 and back["count"] == 12
    assert back["aux"][0] == fs["aux"][2]
    for name in ("params", "ema", "mu", "nu"):
        for x, y in zip(tree_leaves(back["states"][0][name]), tree_leaves(fs["states"][2][name])):
            np.testing.assert_array_equal(x, y)
