"""moldiff_tpu_torch's training loop around the step, against moldiff_tpu on
the CPU: prune_checkpoints (tests/test_train.py's case, and the JAX
function on the same directory), the AsyncCheckpointer
(tests/test_checkpoint_sharded.py's four cases; its file loads in the JAX
loader), the denoiser's CLI from scratch (keep_ckpts, ckpt_async,
--profile_at) and resumed with --override_lr, the bond predictor's CLI from
scratch and resumed, and the committed training configs as the dicts the
card runs."""
import copy
import math
import os
import pickle

import jax
import numpy as np
import pytest
import torch
import yaml

from moldiff_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from moldiff_tpu.train.trainer import prune_checkpoints as jax_prune_checkpoints
from moldiff_tpu_torch.models.moldiff import MolDiff
from moldiff_tpu_torch.train import settings
from moldiff_tpu_torch.train.checkpoint_async import AsyncCheckpointer
from moldiff_tpu_torch.train.optim import tree_leaves, tree_unflatten
from moldiff_tpu_torch.train.trainer import Trainer, prune_checkpoints


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The CLI runs launch thousands of small ops; beside the other test
    workers on every core, torch's intra-op threads wait on each other at
    each one. One thread keeps it at its own cost."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(d):
    d.mkdir()
    for it in (1000, 2000, 10000, 3000):
        (d / f"{it}.ckpt").write_bytes(b"x")
    (d / "best.ckpt").write_bytes(b"x")       # not numeric: never pruned
    (d / "500.ckpt").mkdir()                  # a numeric directory counts too


def test_prune_checkpoints(tmp_path):
    """The newest two numeric checkpoints stay, best.ckpt is untouched,
    keep 0 keeps all; the JAX function leaves the same directory."""
    d, dj = tmp_path / "port", tmp_path / "jax"
    _layout(d)
    _layout(dj)
    removed = prune_checkpoints(str(d), keep=2)
    left = sorted(os.listdir(d))
    assert left == ["10000.ckpt", "3000.ckpt", "best.ckpt"] and len(removed) == 3
    assert prune_checkpoints(str(d), keep=0) == [] and sorted(os.listdir(d)) == left
    jax_prune_checkpoints(str(dj), keep=2)
    assert sorted(os.listdir(dj)) == left


def _small_cfg() -> dict:
    full = copy.deepcopy(settings.TRAIN_FULL_SYNTHETIC_XL_SCRATCH)
    full["model"].update(node_dim=32, edge_dim=16)
    full["model"]["denoiser"].update(num_blocks=2, dtype="float32")
    full["dataset"]["root"] = "./data/synthetic"   # the demo corpus (v1): fast to make
    full["train"].update(batch_size=4, buckets=[16, 24, 32], val_freq=3, val_batches=1,
                         ckpt_freq=1, keep_ckpts=2)
    return full


@pytest.fixture(scope="module")
def trained():
    """(trainer, a state after one step, config)."""
    full = _small_cfg()
    trainer = Trainer(MolDiff(full["model"], 8, 6, device="cpu"), full["train"])
    gen = torch.Generator().manual_seed(0)
    state = trainer.init_state(gen)
    b, n = 3, 10
    mask = torch.ones(b, n)
    mask[2, 6:] = 0
    batch = {"node_type": torch.randint(0, 7, (b, n), generator=gen),
             "pos": torch.randn((b, n, 3), generator=gen), "node_mask": mask,
             "halfedge_type": torch.randint(0, 5, (b, n * (n - 1) // 2), generator=gen)}
    state, _ = trainer.train_step(state, batch, trainer.draw_step_noise(batch, gen))
    return trainer, state, full


def test_async_checkpoint_matches_sync(trained, tmp_path):
    """The async file holds what the synchronous save writes; the port
    resumes from it and the JAX loader reads it."""
    trainer, state, full = trained
    sync, asy = str(tmp_path / "sync.ckpt"), str(tmp_path / "async.ckpt")
    trainer.save_checkpoint(sync, state, full)
    ac = AsyncCheckpointer()
    ac.save(asy, state, full, scheduler=trainer.scheduler)
    ac.wait()
    with open(sync, "rb") as f:
        a = pickle.load(f)
    with open(asy, "rb") as f:
        b = pickle.load(f)
    assert a["step"] == b["step"] == 1 and a["config"] == b["config"]
    assert a["scheduler"] == b["scheduler"]
    for tree in ("params", "ema_params"):
        for x, y in zip(jax.tree.leaves(a[tree]), jax.tree.leaves(b[tree])):
            np.testing.assert_array_equal(x, y)
    opt_a, opt_b = a["extra"]["optimizer"], b["extra"]["optimizer"]
    assert opt_a["count"] == opt_b["count"] == 1 and opt_a["lr"] == opt_b["lr"]
    for x, y in zip(jax.tree.leaves((opt_a["mu"], opt_a["nu"])),
                    jax.tree.leaves((opt_b["mu"], opt_b["nu"]))):
        np.testing.assert_array_equal(x, y)
    back = Trainer(trainer.model, full["train"]).load_checkpoint(asy, "cpu")
    assert back.step == 1 and back.opt_state.count == 1
    blob = jax_load_checkpoint(asy)
    assert blob["step"] == 1
    for x, y in zip(jax.tree.leaves(blob["params"]), tree_leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_async_snapshot_survives_update(trained, tmp_path):
    """The file holds the state at the call, though the params are then
    changed in place before the write is joined."""
    trainer, state, full = trained
    params = [p.clone() for p in tree_leaves(state.params)]
    st = state._replace(params=tree_unflatten(state.params, params))
    want = params[0].numpy().copy()
    ac = AsyncCheckpointer()
    path = str(tmp_path / "snap.ckpt")
    ac.save(path, st, full)
    for p in params:
        p.add_(1.0)
    ac.wait()
    got = jax.tree.leaves(jax_load_checkpoint(path)["params"])[0]
    np.testing.assert_array_equal(np.asarray(got), want)


def test_async_never_a_partial_file(trained, tmp_path):
    trainer, state, full = trained
    ac = AsyncCheckpointer()
    path = str(tmp_path / "atomic.ckpt")
    ac.save(path, state, full)
    ac.wait()
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    with open(path, "rb") as f:
        pickle.load(f)   # complete, parseable


def test_async_back_to_back_saves_ordered(trained, tmp_path):
    """Saves to one path land in order (each waits for the last): the file
    holds the last state. An error on the writer thread is raised by the
    next wait."""
    trainer, state, full = trained
    ac = AsyncCheckpointer()
    path = str(tmp_path / "ordered.ckpt")
    for step in (5, 6, 7):
        ac.save(path, state._replace(step=step), full)
    ac.wait()
    assert jax_load_checkpoint(path)["step"] == 7
    (tmp_path / "taken.ckpt").mkdir()
    ac.save(str(tmp_path / "taken.ckpt"), state, full)
    with pytest.raises(OSError):
        ac.wait()


def _write_yaml(cfg: dict, path) -> str:
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def test_train_cli_from_scratch_then_resumed(tmp_path):
    """python -m moldiff_tpu_torch.train without --resume: 3 steps from
    fresh params, a checkpoint each step (ckpt_async) of which the newest
    two stay (keep_ckpts 2), the last equal to the final state; --profile_at
    2 writes a trace. Resumed from it with --override_lr: the learning rate
    of the next step and of its checkpoint is the override."""
    from moldiff_tpu_torch.train import cli as train_cli

    cfg = _write_yaml(_small_cfg(), tmp_path / "small.yml")
    common = ["--config", cfg, "--device", "cpu", "--corpus_mols", "40",
              "--logdir", str(tmp_path / "logs")]
    log_dir = train_cli.main(common + ["--max_iters", "3", "--profile_at", "2", "--name", "a"])
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    assert sorted(os.listdir(ckpt_dir)) == ["2.ckpt", "3.ckpt"]
    trace = os.path.join(log_dir, "profile", "trace_it2.json")
    assert os.path.getsize(trace) > 0
    last = os.path.join(ckpt_dir, "3.ckpt")
    blob = jax_load_checkpoint(last)
    assert blob["step"] == 3 and blob["config"]["train"]["ckpt_async"]
    assert blob["extra"]["optimizer"]["lr"] == pytest.approx(3e-4)

    out = train_cli.run(_small_cfg(), last, device="cpu", logdir=str(tmp_path / "logs"),
                        name="b", max_iters=4, override_lr=1e-5, corpus_mols=40,
                        log=lambda m: None)
    assert [s["it"] for s in out["steps"]] == [4] and out["steps"][0]["lr"] == 1e-5
    assert math.isfinite(out["steps"][0]["loss"])
    with open(out["checkpoints"][-1], "rb") as f:
        assert pickle.load(f)["extra"]["optimizer"]["lr"] == 1e-5


def test_train_cli_final_state_is_last_checkpoint(tmp_path):
    """run() from scratch: the last kept checkpoint, reloaded, equals the
    final state leaf for leaf, EMA included."""
    from moldiff_tpu_torch.train import cli as train_cli

    full = _small_cfg()
    out = train_cli.run(full, None, device="cpu", logdir=str(tmp_path), max_iters=2,
                        corpus_mols=40, log=lambda m: None)
    assert [s["it"] for s in out["steps"]] == [1, 2]
    back = Trainer(out["trainer"].model, full["train"]).load_checkpoint(out["checkpoints"][-1],
                                                                        "cpu")
    for a, b in zip(tree_leaves((back.params, back.ema_params)),
                    tree_leaves((out["state"].params, out["state"].ema_params))):
        assert torch.equal(a, b)


def _small_bond_cfg() -> dict:
    full = copy.deepcopy(settings.TRAIN_BONDPRED_DEMO)
    full["model"].update(node_dim=32, edge_dim=16)
    full["model"]["encoder"].update(num_blocks=2, dtype="float32")
    full["train"].update(batch_size=4, buckets=[16, 24, 32], val_freq=2, val_batches=1,
                         ckpt_freq=2, keep_ckpts=1, ckpt_async=True)
    return full


def test_bond_cli_from_scratch_and_resumed(tmp_path):
    """python -m moldiff_tpu_torch.train.bond: 2 steps from scratch (a log
    line of loss and acc_bond, a validation that steps the scheduler, one
    kept checkpoint the JAX loader reads), then resumed from it for 2 more."""
    from moldiff_tpu_torch.train import bond_cli

    logs = []
    cfg = _write_yaml(_small_bond_cfg(), tmp_path / "bond.yml")
    log_dir = bond_cli.main(["--config", cfg, "--device", "cpu", "--corpus_mols", "40",
                             "--max_iters", "2", "--logdir", str(tmp_path / "logs")])
    ckpt = os.path.join(log_dir, "checkpoints", "2.ckpt")
    assert os.listdir(os.path.dirname(ckpt)) == ["2.ckpt"]
    blob = jax_load_checkpoint(ckpt)
    assert blob["step"] == 2 and blob["config"]["model"]["name"] == "bond_predictor"
    assert blob["params"]["edge_decoder"]["layers"][2]["lin"]["w"].shape == (16, 5)
    out = bond_cli.run(_small_bond_cfg(), ckpt, device="cpu", logdir=str(tmp_path / "logs"),
                       max_iters=4, corpus_mols=40, log=logs.append)
    assert logs[0].startswith("resumed from") and [s["it"] for s in out["steps"]] == [3, 4]
    assert any(m.startswith("[it 3] loss") and "acc_bond" in m for m in logs)
    assert all(math.isfinite(s["loss"]) and 0 <= s["acc_bond"] <= 1 for s in out["steps"])
    assert len(out["val"]) == 1 and math.isfinite(out["val"][0]["loss"])
    assert sorted(os.listdir(os.path.join(out["log_dir"], "checkpoints"))) == ["4.ckpt"]


@pytest.mark.parametrize("name,path", [
    ("TRAIN_V2_CONT", "train_v2_cont"),
    ("TRAIN_FULL_SYNTHETIC_XL_SCRATCH", "train_full_synthetic_xl_scratch"),
    ("TRAIN_DEMO_SYNTHETIC_30K", "train_demo_synthetic_30k"),
    ("TRAIN_BONDPRED_V2", "train_bondpred_v2"),
    ("TRAIN_BONDPRED_DEMO", "train_bondpred_demo"),
])
def test_settings_equal_their_yaml(name, path):
    with open(f"configs/train/{path}.yml") as f:
        assert getattr(settings, name) == yaml.safe_load(f)


@pytest.mark.parametrize("name,path,section,values", [
    ("MOE_V2", "train_v2_cont", "denoiser", {"moe": {"num_experts": 4, "top_k": 2}}),
    ("MOE_BONDPRED_V2", "train_bondpred_v2", "encoder",
     {"moe": {"num_experts": 4, "top_k": 2}}),
    ("CONT_V2", "train_v2_cont", "diff", {"categorical_space": "continuous",
                                          "scaling": [1.0, 4.0, 8.0]}),
    ("UNGATED_V2", "train_v2_cont", "denoiser", {"use_gate": False}),
])
def test_variant_settings_are_their_yaml_plus_one_override(name, path, section, values):
    """The model variants chip_smoke.py's phase 21 runs: a committed
    config with one override of one section, the rest untouched."""
    with open(f"configs/train/{path}.yml") as f:
        want = yaml.safe_load(f)
    want["model"][section].update(values)
    assert getattr(settings, name) == want


@pytest.mark.parametrize("name,sections", [
    ("TRAIN_V2_CONT_DP2", {"parallel": {"num_devices": 2}}),
    ("TRAIN_V2_CONT_FSDP2", {"parallel": {"num_devices": 2, "fsdp": True},
                             "train": {"ckpt_sharded": True}}),
    ("TRAIN_V2_CONT_PP2", {"parallel": {"num_devices": 2, "pipe": 2},
                           "train": {"num_microbatches": 2}}),
    ("MOE_V2_EP2", {"parallel": {"num_devices": 2, "expert": 2}}),
    ("MOE_V2_DP2", {"parallel": {"num_devices": 2}}),
    ("TRAIN_V2_CONT_GRAPH2", {"parallel": {"num_devices": 2, "graph": 2}}),
    ("TRAIN_V2_CONT_TP2", {"parallel": {"num_devices": 2, "model": 2}}),
])
def test_parallel_settings_are_their_yaml_plus_overrides(name, sections):
    """The mesh settings chip_smoke.py's phases 22-24 run:
    train_v2_cont.yml (with MOE_V2's expert bank for the MOE_ ones) with
    its parallel section (and train.ckpt_sharded or
    train.num_microbatches) overridden, the rest untouched."""
    with open("configs/train/train_v2_cont.yml") as f:
        want = yaml.safe_load(f)
    if name.startswith("MOE_"):
        want["model"]["denoiser"]["moe"] = {"num_experts": 4, "top_k": 2}
    for section, values in sections.items():
        want[section].update(values)
    assert getattr(settings, name) == want


def test_train_gates_are_the_committed_configs():
    """chip_smoke.py's --train-gate names resolve to the settings dicts of
    the configs they train (held to their YAML files above), and its JAX
    bar is the validation curve of results/demo30k_metrics.jsonl, JAX's run
    of the same config (results/demo30k_config.yml)."""
    import json

    import chip_smoke

    assert chip_smoke.TRAIN_GATES == {"demo_scratch": settings.TRAIN_DEMO_SYNTHETIC_30K,
                                      "bondpred_demo_scratch": settings.TRAIN_BONDPRED_DEMO}
    with open("results/demo30k_config.yml") as f:
        assert yaml.safe_load(f) == settings.TRAIN_DEMO_SYNTHETIC_30K
    with open("results/demo30k_metrics.jsonl") as f:
        val = {r["step"]: r["value"] for r in map(json.loads, f) if r["tag"] == "val/loss"}
    steps = range(500, chip_smoke.TRAIN_GATE_STEPS + 1, 500)
    assert chip_smoke.JAX_DEMO30K_VAL == {s: val[s] for s in steps}
    assert np.mean(list(chip_smoke.JAX_DEMO30K_VAL.values())) == pytest.approx(1.7089, abs=1e-4)
    assert chip_smoke.TRAIN_GATE_CORPUS == ("./data/synthetic", 8000)
