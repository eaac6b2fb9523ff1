"""The port's sampling pipeline and CLI on the CPU, end to end at a small
size: the demo checkpoint (T = 200), generate until one molecule, decode,
classify, write SMILES.txt / SDF / summary.json; trajectories, the EMA
weights, the JAX CLI's flags, and chip_smoke.py's gate settings."""
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from moldiff_tpu_torch.sample import cli
from moldiff_tpu_torch.sample.pipeline import MolSampler


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The CLI runs launch thousands of small ops; beside the other test
    workers on every core, torch's intra-op threads wait on each other at
    each one (one run read 425 s so, 5 s alone). One thread keeps it at
    its own cost."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_run_on_cpu(tmp_path):
    config = {"model": {"checkpoint": "ckpts/demo_synthetic_30k.ckpt"},
              "sample": {"seed": 1, "batch_size": 4, "num_mols": 1, "size_mean": 9.0,
                         "size_std": 1.0, "sanitize_mode": "reference", "commit": "nodes",
                         "buckets": [12]}}
    logs = []
    summary = cli.run(config, device="cpu", outdir=str(tmp_path), run_name="r", log=logs.append)
    out = tmp_path / "r"
    assert summary["num_finished"] == 1
    assert summary["chains"] >= 1 and summary["num_classified"] >= 1
    assert summary["num_classified"] == summary["chains"] * 4
    lo, hi = summary["success_wilson95"]
    assert 0.0 <= lo <= summary["success_rate"] <= hi <= 1.0
    smiles = (out / "SMILES.txt").read_text().split()
    assert len(smiles) == 1 and "." not in smiles[0]
    assert os.path.exists(out / "SDF" / "0.sdf")
    assert json.loads((out / "summary.json").read_text())["num_finished"] == 1


def test_cli_run_guided_on_cpu(tmp_path):
    """The guided path end to end: the demo bond predictor steers positions
    (uncertainty guidance) and bonds are perceived from distances, as the
    guided flagship config asks; summary.json records the settings and the
    JAX CLI's success rate beside the rate over all classified molecules."""
    config = {"model": {"checkpoint": "ckpts/demo_synthetic_30k.ckpt"},
              "bond_predictor": "ckpts/demo_bondpred_4k.ckpt",
              "sample": {"seed": 2, "batch_size": 4, "num_mols": 1, "size_mean": 9.0,
                         "size_std": 1.0, "sanitize_mode": "reference", "commit": "nodes",
                         "add_edge": "distance", "guidance": ["uncertainty", 1.0e-4],
                         "guidance_interval": 4, "buckets": [12]}}
    summary = cli.run(config, device="cpu", outdir=str(tmp_path), run_name="g", log=lambda m: 0)
    assert summary["num_finished"] == 1
    assert summary["guidance"] == ["uncertainty", 1.0e-4] and summary["add_edge"] == "distance"
    assert summary["success_rate"] == 1 / (1 + summary["num_failed"])
    k = summary["num_classified"] - summary["num_failed"]
    assert summary["success_rate_classified"] == k / summary["num_classified"]
    lo, hi = summary["success_wilson95_classified"]
    assert lo <= summary["success_rate_classified"] <= hi
    assert set(summary["accept_stage_counts"]) == {"sanitize"}


def test_cli_refuses_unported_settings(tmp_path):
    """What the CLI still refuses: a position sampler the JAX package lacks,
    and edge guidance on a checkpoint of the continuous categorical mode
    (JAX ignores it there; the port raises)."""
    import pickle

    from moldiff_tpu_torch.utils.checkpoint import load_checkpoint_numpy

    config = {"model": {"checkpoint": "ckpts/demo_synthetic_30k.ckpt"},
              "sample": {"seed": 1, "batch_size": 4, "num_mols": 1, "num_steps": 100,
                         "pos_sampler": "euler"}}
    with pytest.raises(ValueError, match="pos_sampler"):
        cli.run(config, device="cpu", outdir=str(tmp_path))
    blob = load_checkpoint_numpy("ckpts/demo_synthetic_30k.ckpt")
    blob["config"] = blob["config"].to_dict()
    blob["config"]["model"]["diff"]["categorical_space"] = "continuous"
    path = tmp_path / "continuous.ckpt"
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    config = {"model": {"checkpoint": str(path)},
              "bond_predictor": "ckpts/demo_bondpred_4k.ckpt",
              "sample": {"seed": 1, "batch_size": 4, "num_mols": 1, "edge_guidance": 1.0}}
    with pytest.raises(ValueError, match="edge_guidance"):
        cli.run(config, device="cpu", outdir=str(tmp_path))


def test_entry_points_default_to_cuda():
    """Without a card, asking for the default device fails loudly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.run({"model": {"checkpoint": "ckpts/demo_synthetic_30k.ckpt"},
                 "sample": {"seed": 1, "batch_size": 4, "num_mols": 1}})


@pytest.mark.parametrize("k,n,want", [(0, 0, (0.0, 1.0)), (5, 10, (0.2366, 0.7634)),
                                      (745, 1000, (0.7171, 0.7710))])
def test_wilson_interval(k, n, want):
    np.testing.assert_allclose(cli.wilson_interval(k, n), want, atol=1e-4)


def test_sizes_and_buckets():
    """Sizes clip to [3, largest bucket]; each bucket runs in batches padded
    to batch_size."""
    class Stub:
        device = torch.device("cpu")

        def __init__(self):
            self.masks = []

        def sample(self, params, node_mask, generator, **chain):
            self.masks.append(node_mask)
            b, n = node_mask.shape
            from moldiff_tpu_torch.models.moldiff import MolDiffPreds
            return MolDiffPreds(torch.zeros(b, n, 8), torch.zeros(b, n, 3),
                                torch.zeros(b, n * (n - 1) // 2, 6))

    stub = Stub()
    from moldiff_tpu_torch.data.featurize import MolFeaturizer

    sampler = MolSampler(stub, MolFeaturizer(), buckets=[40, 32], batch_size=3)
    sizes = sampler.draw_sizes(1000, np.random.default_rng(0))
    assert sizes.min() >= 3 and sizes.max() <= 40
    out = sampler.sample_sizes(None, np.array([30, 35, 31, 5, 32]), torch.Generator())
    assert [tuple(m.shape) for m in stub.masks] == [(3, 32), (3, 32), (3, 40)]
    assert stub.masks[1].sum(1).tolist() == [32, 3, 3]  # padded with 3-atom graphs
    assert sampler.chains == 3 and len(out) == 5
    assert [len(d["element"]) for d in out] == [30, 35, 31, 5, 32]


def test_cli_writes_the_jax_cli_outputs(tmp_path):
    """samples_all.pkl and summary.json carry the JAX CLI's keys
    (scripts/sample_drug3d.py:347-396): every classified molecule with its
    decoded arrays, the aromatic and triple-bond fractions, and
    edge_guidance_tmax (a falsy value read as every step, None)."""
    import pickle

    from moldiff_tpu_torch.chem.mol import AROMATIC

    config = {"model": {"checkpoint": "ckpts/demo_synthetic_30k.ckpt"},
              "bond_predictor": "ckpts/demo_bondpred_4k.ckpt",
              "sample": {"seed": 3, "batch_size": 4, "num_mols": 1, "size_mean": 9.0,
                         "size_std": 1.0, "sanitize_mode": "reference", "commit": "nodes",
                         "edge_guidance": 1.0, "edge_guidance_tmax": 0, "buckets": [12]}}
    summary = cli.run(config, device="cpu", outdir=str(tmp_path), run_name="o", log=lambda m: 0)
    assert summary["edge_guidance_tmax"] is None and summary["edge_guidance"] == 1.0
    with open(tmp_path / "o" / "samples_all.pkl", "rb") as f:
        pool = pickle.load(f)
    assert set(pool) == {"finished", "failed", "wall_s", "success_rate"}
    assert len(pool["finished"]) == summary["num_finished"]
    assert len(pool["failed"]) == summary["num_failed"]
    assert all(set(e) == {"smiles", "decoded", "stage"} for e in pool["finished"])
    assert all(set(e) == {"reason", "decoded"} for e in pool["failed"])
    assert {"element", "atom_pos"} <= set(pool["finished"][0]["decoded"])
    assert pool["success_rate"] == summary["success_rate"]
    on_disk = json.loads((tmp_path / "o" / "summary.json").read_text())
    from moldiff_tpu_torch.chem.sdf import read_sdf

    mols = [next(read_sdf(str(tmp_path / "o" / "SDF" / f"{k}.sdf")))
            for k in range(summary["num_finished"])]
    for key, order in (("aromatic_mol_fraction", AROMATIC), ("triple_bond_mol_fraction", 3)):
        want = sum(any(b.order == order for b in m.bonds) for m in mols) / len(mols)
        assert on_disk[key] == summary[key] == want


def test_cli_writes_trajectories(tmp_path):
    """save_traj_prob 1.0 on a respaced DDIM chain: every finished molecule
    k gets SDF/traj_<k>.sdf with S + 1 states named step_0 ... step_S (the
    prior draw first), and summary.json records the chain's settings. The
    chain's Trajectory holds S + 1 states: the prior draw first, the last
    one's positions the final x0 prediction (the t = 0 step returns it),
    its atom classes the committed ones; its bonds are the step-0 draw,
    which decode's argmax need not equal."""
    from moldiff_tpu_torch.chem.sdf import read_sdf
    from moldiff_tpu_torch.data.batching import node_mask_from_counts

    config = {"model": {"checkpoint": "ckpts/demo_synthetic_30k.ckpt"},
              "sample": {"seed": 4, "batch_size": 4, "num_mols": 2, "size_mean": 9.0,
                         "size_std": 1.0, "sanitize_mode": "reference", "commit": "nodes",
                         "buckets": [12], "num_steps": 10, "pos_sampler": "ddim", "eta": 0.5,
                         "save_traj_prob": 1.0}}
    summary = cli.run(config, device="cpu", outdir=str(tmp_path), run_name="t", log=lambda m: 0)
    assert (summary["num_steps"], summary["pos_sampler"], summary["eta"]) == (10, "ddim", 0.5)
    assert summary["num_trajectories"] == summary["num_finished"] == 2
    for k in range(2):
        path = str(tmp_path / "t" / "SDF" / f"traj_{k}.sdf")
        assert len(list(read_sdf(path))) == 11
        with open(path) as f:
            names = [line.strip() for line in f if line.startswith("step_")]
        assert names == [f"step_{t}" for t in range(11)]

    sampler, params = cli.build_sampler(config["model"]["checkpoint"], config["sample"],
                                        torch.device("cpu"))
    model = sampler.model
    mask = torch.from_numpy(node_mask_from_counts(np.array([9, 12, 7, 10]), 12))
    g = torch.Generator().manual_seed(0)
    prior = model.init_state(mask, model.draw_noise(4, 12, torch.Generator().manual_seed(0)))
    preds, traj = model.sample(params, mask, g, commit="nodes", num_steps=10,
                               pos_sampler="ddim", eta=0.5, save_traj=True)
    assert traj.node.shape == (11, 4, 12) and traj.halfedge.shape == (11, 4, 66)
    assert torch.equal(traj.pos[0], prior.pos) and torch.equal(traj.pos[-1], preds.pred_pos)
    assert torch.equal(traj.node[0].long(), prior.h_node.argmax(-1))
    committed = preds.pred_node.max(-1).values == 0.0   # clamped one-hots: log 1
    assert committed.any()
    assert torch.equal(traj.node[-1].long()[committed], preds.pred_node.argmax(-1)[committed])


def test_cli_flags_and_ema(tmp_path):
    """main() takes the JAX CLI's single-process flags over the config, and
    --use_ema samples the checkpoint's ema_params; a checkpoint without
    them is refused."""
    import yaml

    from moldiff_tpu_torch.utils.checkpoint import load_checkpoint

    sampler, params = cli.build_sampler("ckpts/flagship_v2.ckpt", {"use_ema": True},
                                        torch.device("cpu"), batch_size=2)
    ck = load_checkpoint("ckpts/flagship_v2.ckpt", device="cpu")
    w = ("denoiser", "blocks", "edge_emb", "w")
    get = lambda tree: tree[w[0]][w[1]][w[2]][w[3]]
    assert torch.equal(get(params), get(ck["ema_params"]))
    assert not torch.equal(get(params), get(ck["params"]))
    with pytest.raises(ValueError, match="ema_params"):
        cli.build_sampler("ckpts/demo_synthetic_30k.ckpt", {"use_ema": True},
                          torch.device("cpu"), batch_size=2)
    cfg = tmp_path / "c.yml"
    cfg.write_text(yaml.safe_dump({
        "model": {"checkpoint": "ckpts/flagship_v2.ckpt"},
        "sample": {"seed": 1, "batch_size": 4, "num_mols": 1, "size_mean": 9.0, "size_std": 1.0,
                   "buckets": [12]}}))
    summary = cli.main(["--config", str(cfg), "--device", "cpu", "--outdir", str(tmp_path),
                        "--batch_size", "2", "--use_ema", "--num_steps", "2", "--commit", "both",
                        "--sanitize_mode", "repo", "--add_edge", "connect", "--run_name", "e"])
    on_disk = json.loads((tmp_path / "e" / "summary.json").read_text())
    assert on_disk == json.loads(json.dumps(summary))
    assert summary["use_ema"] and summary["num_steps"] == 2 and summary["commit"] == "both"
    assert summary["sanitize_mode"] == "repo" and summary["add_edge"] == "connect"


def test_generate_keeps_trajectories_in_jax_rng_order(monkeypatch):
    """generate(traj_prob) draws one uniform per finished molecule, in pool
    order after each batch's sizes, as JAX's pipeline.py:361-407 does: a
    stub chain (zero predictions, a 2-step trajectory) and a stub
    classification (odd sizes finish) keep exactly the trajectories that
    rule picks from the same numpy seed, as one-hots of [S + 1, n, K]."""
    from moldiff_tpu_torch.data.featurize import MolFeaturizer
    from moldiff_tpu_torch.models.moldiff import MolDiffPreds, Trajectory
    from moldiff_tpu_torch.sample import pipeline

    class Stub:
        device = torch.device("cpu")
        num_timesteps, num_node_types, num_edge_types = 2, 8, 6

        def sample(self, params, node_mask, generator, save_traj=False, **chain):
            b, n = node_mask.shape
            e = n * (n - 1) // 2
            preds = MolDiffPreds(torch.zeros(b, n, 8), torch.zeros(b, n, 3),
                                 torch.zeros(b, e, 6))
            traj = Trajectory(torch.full((3, b, n), 2, dtype=torch.uint8),
                              torch.arange(3 * b * n * 3, dtype=torch.float32).reshape(3, b, n, 3),
                              torch.ones((3, b, e), dtype=torch.uint8))
            return (preds, traj) if save_traj else preds

    monkeypatch.setattr(pipeline, "classify_decoded", lambda d, **kw: {
        "pool": "finished" if len(d["element"]) % 2 else "failed", "decoded": d,
        "smiles": "C", "reason": "stub"})
    sampler = MolSampler(Stub(), MolFeaturizer(), buckets=[12], batch_size=6, size_mean=8.0,
                         size_std=3.0)
    pool = sampler.generate(None, 6, torch.Generator(), rng=np.random.default_rng(3),
                            batch_graphs=6, traj_prob=0.5)
    rng, want = np.random.default_rng(3), []
    while len(want) < len(pool["finished"]):
        for size in sampler.draw_sizes(6, rng):
            if size % 2:
                want.append(bool(rng.random() < 0.5))
    assert [("traj" in e) for e in pool["finished"]] == want[:len(pool["finished"])]
    assert 0 < sum(want) < len(want)
    for e in pool["finished"]:
        if "traj" in e:
            n = len(e["decoded"]["element"])
            assert e["traj"]["node"].shape == (3, n, 8) and e["traj"]["pos"].shape == (3, n, 3)
            assert e["traj"]["halfedge"].shape == (3, n * (n - 1) // 2, 6)
            assert (e["traj"]["node"].argmax(-1) == 2).all()
            assert (e["traj"]["halfedge"].sum(-1) == 1).all()


@pytest.mark.parametrize("name", sorted(chip_smoke.GATES))
def test_gate_settings_are_yaml_plus_overrides(name):
    """Each of chip_smoke.py's --gate settings is its committed YAML's with
    its named overrides set (the card machine has no PyYAML)."""
    import copy

    import yaml

    path, top, sample = chip_smoke.GATES[name]
    with open(path) as f:
        want = yaml.safe_load(f)
    want = dict(copy.deepcopy(want), **top)
    want["sample"].update(sample)
    assert chip_smoke.gate_settings(name) == want
