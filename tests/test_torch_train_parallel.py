"""The train CLIs on the data axis on the CPU: ``parallel.num_devices: 2``
starts two gloo processes. A 2-step FSDP run of the denoiser's CLI with
``train.ckpt_sharded`` (rank 0's run records: log.txt, metrics.jsonl, the
event file; both ranks' step records equal; one sharded checkpoint kept),
then ``--resume`` from that directory; one data-parallel step of the
bond predictor's CLI (the params bit-equal on both ranks after it; a
pickle checkpoint the JAX loader reads); and a MoE denoiser on
``parallel.expert: 2`` with ``train.ckpt_sharded`` (the expert banks split
over the two ranks in the directory, read back whole)."""
import copy
import json
import math
import os

import numpy as np

from moldiff_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from moldiff_tpu_torch.train import bond_cli
from moldiff_tpu_torch.train import checkpoint_sharded
from moldiff_tpu_torch.train import cli as train_cli
from moldiff_tpu_torch.train.settings import MOE_V2_EP2, TRAIN_BONDPRED_DEMO, TRAIN_V2_CONT_FSDP2


def _small(settings: dict, section: str) -> dict:
    cfg = copy.deepcopy(settings)
    cfg["model"].update(node_dim=32, edge_dim=16)
    cfg["model"][section].update(num_blocks=2, dtype="float32")
    cfg["train"].update(batch_size=4, buckets=[16, 24, 32], val_freq=2, val_batches=1,
                        ckpt_freq=1, keep_ckpts=1)
    cfg["dataset"]["root"] = "./data/synthetic"   # the demo corpus recipe, made in memory
    return cfg


def test_train_cli_fsdp_two_ranks_sharded_checkpoint_and_resume(tmp_path):
    cfg = _small(TRAIN_V2_CONT_FSDP2, "denoiser")
    logs = []
    out = train_cli.run(cfg, None, device="cpu", logdir=str(tmp_path / "logs"), max_iters=2,
                        corpus_mols=40, log=logs.append)
    assert len(out["ranks"]) == 2 and out["state"] is None
    assert any("data axis: 2 ranks (gloo) FSDP" in m for m in logs)
    r0, r1 = (r["steps"] for r in out["ranks"])
    assert [s["it"] for s in r0] == [1, 2]
    for a, b in zip(r0, r1):
        for k in ("loss", "loss_pos", "loss_node", "loss_edge", "loss_len", "grad_norm", "lr"):
            assert a[k] == b[k] and math.isfinite(a[k]), k
        assert a["comm_s"] >= 0
    assert len(out["val"]) == 1 and out["ranks"][1]["val"] == out["val"]
    log_dir = out["log_dir"]
    assert out["ranks"][1]["log_dir"] == log_dir
    names = os.listdir(log_dir)
    assert "log.txt" in names and "metrics.jsonl" in names
    assert any(n.startswith("events.out.tfevents") for n in names)
    tags = [json.loads(line)["tag"] for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    assert tags.count("train/loss") == 1 and tags.count("val/loss") == 1
    with open(os.path.join(log_dir, "log.txt")) as f:
        assert f.read().count("[it 1] loss") == 1       # rank 0 alone writes it
    ckpts = os.listdir(os.path.join(log_dir, "checkpoints"))
    assert ckpts == ["2.ckpt"]                           # keep_ckpts 1 pruned 1.ckpt
    path = os.path.join(log_dir, "checkpoints", "2.ckpt")
    assert checkpoint_sharded.is_sharded_checkpoint(path)
    meta = checkpoint_sharded.read_meta(path)
    assert meta["world"] == 2 and any(s["sharded"] for s in meta["specs"])
    back = train_cli.run(cfg, path, device="cpu", logdir=str(tmp_path / "logs2"), max_iters=3,
                         corpus_mols=40, log=logs.append)
    assert [s["it"] for s in back["steps"]] == [3]
    assert math.isfinite(back["steps"][0]["loss"])
    assert os.listdir(os.path.join(back["log_dir"], "checkpoints")) == ["3.ckpt"]
    st = checkpoint_sharded.load_checkpoint_sharded(
        os.path.join(back["log_dir"], "checkpoints", "3.ckpt"))["state"]
    assert int(st["step"]) == 3 and int(st["opt_state"]["count"]) == 3


def test_bond_cli_two_ranks(tmp_path):
    cfg = _small(TRAIN_BONDPRED_DEMO, "encoder")
    cfg["parallel"]["num_devices"] = 2
    cfg["train"].update(val_freq=1)
    out = bond_cli.run(cfg, None, device="cpu", logdir=str(tmp_path / "logs"), max_iters=1,
                       corpus_mols=40, check_replicas=True)
    s0, s1 = (r["steps"][0] for r in out["ranks"])
    assert s0["loss"] == s1["loss"] and 0.0 <= s0["acc_bond"] <= 1.0
    assert s0["replicas_equal"] and s1["replicas_equal"]   # the params bit-equal on both ranks
    blob = jax_load_checkpoint(out["checkpoints"][0])
    assert blob["step"] == 1 and np.isfinite(out["val"][0]["loss"])


def test_train_cli_expert_two_ranks(tmp_path):
    cfg = _small(MOE_V2_EP2, "denoiser")
    cfg["train"].update(ckpt_sharded=True)
    logs = []
    out = train_cli.run(cfg, None, device="cpu", logdir=str(tmp_path / "logs"), max_iters=1,
                        corpus_mols=40, log=logs.append, check_replicas=True)
    assert any("data axis: 1 ranks (gloo), expert axis: 2 ranks" in m for m in logs)
    s0, s1 = (r["steps"][0] for r in out["ranks"])
    assert s0["loss"] == s1["loss"] and s0["loss_moe"] > 0 and s0["replicas_equal"]
    path = out["checkpoints"][0]
    meta = checkpoint_sharded.read_meta(path)
    experts = [i for i, p in enumerate(meta["paths"])
               if p[0] == "params" and "experts" in p]
    assert experts and all(meta["specs"][i]["sharded"] for i in experts)
    assert sum(os.path.basename(f).startswith(f"leaf{experts[0]}_") for f in os.listdir(path)) == 2
    st = checkpoint_sharded.load_checkpoint_sharded(path)["state"]
    w = st["params"]["denoiser"]["blocks"]["node_block"]["node_net"]["experts"]
    assert w["layers"][0]["lin"]["w"].shape[:2] == (2, 4) and int(st["step"]) == 1
